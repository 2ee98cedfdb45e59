"""Stackless threaded BVH over Morton-sorted leaves (port of scene/bvh.py).

The tree is an implicit complete binary heap: triangles sorted by the
30-bit Morton code of their centroid, cut into leaves of LEAF_SIZE, padded
to a power of two; children of node i are 2i+1 and 2i+2, and every node
carries a miss link (the next node in preorder once its subtree is skipped
or done). Pad leaves get inverted boxes (min +big, max -big) that the walk's
validity term culls. The build is the JAX package's vectorised numpy one,
copied, and gives the same arrays (tests/test_torch_bvh.py).

`attach` packs the tree into kernel-ready tables:
  nodes      (M, 8) f32: min xyz, max xyz, miss link (int32 bits), 0 --
             the binary heap, packed; after `attach` the heap fields
             aabb_min / aabb_max / miss_link are views of it, so the heap
             is stored once. The walk reads `wide`, collapsed from it;
  leaf_tris  (L, 9, LEAF_SIZE) f32: per leaf, the rows p0x p0y p0z e1x e1y
             e1z e2x e2y e2z of its four triangles, 144 contiguous bytes,
             so a leaf is nine 16-byte loads from two cache lines. Pad
             slots hold the far degenerate triangle the JAX walk
             substitutes (p0 = 3e37, e1 = e2 = 0), which never hits;
  leaf_opaque (L*LEAF_SIZE,) bool: tri_opaque in leaf order (pads False);
  wide       (W, 32) f32: the binary heap collapsed into a 4-wide tree, one
             128-byte record per wide node (`wide_nodes`), which the walk
             reads; `wide_depth` is its number of levels.
The CUDA walk and its plain twin both read `wide`, `leaf_tris` and
`leaf_opaque`, so they see the same values; e1 and e2 are the same
float32 differences the JAX walk forms.

The 4-wide tree keeps the binary heap's boxes unchanged: the wide node of
binary node b holds b's four grandchildren. Where the binary depth is odd
the root alone holds its two children (two empty slots), so every node
below it is full down to the leaves (a tree of one leaf: that leaf and
three empty slots). Record of a wide node:
  [0:4) min x, [4:8) min y, [8:12) min z, [12:16) max x, [16:20) max y,
  [20:24) max z of its four children (SoA), [24:28) their references as
  int32 bits (>= 0: a wide node's index; < 0: leaf -1 - ref; EMPTY: an
  empty slot), [28:32) zero.
Empty slots get the inverted box of a pad leaf, which the walk's validity
term culls, so they are never followed. Wide nodes are numbered level by
level; 70,034 triangles (32,768 leaves, 15 binary levels below the root)
give 8 wide levels instead of 15, and 10,923 records. (Putting the half
level at the bottom instead, two leaves per bottom node, took 11% more
fetches on the big-mesh render's bounce rays.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

LEAF_SIZE = 4
# p0 of the degenerate triangle that fills a pad slot
FAR = 3.0e37
# box of a pad leaf (min +BIG, max -BIG), also given to empty wide slots
BIG = np.float32(3e38)
# child reference of an empty wide slot
EMPTY = np.iinfo(np.int32).min
WIDE = 4              # children per wide node
WIDE_RECORD = 32      # floats per wide node record (128 bytes)


@dataclasses.dataclass
class BVH:
    """M = 2L-1 heap nodes over L leaves; leaf i covers sorted-triangle
    slots [i*LEAF_SIZE, (i+1)*LEAF_SIZE)."""

    aabb_min: torch.Tensor   # (M,3)
    aabb_max: torch.Tensor   # (M,3)
    miss_link: torch.Tensor  # (M,) int32: node to visit when skipping/leaving
    tri_order: torch.Tensor  # (L*LEAF_SIZE,) int32 original tri id (or -1 pad)
    n_internal: int = 0      # = L-1
    n_leaves: int = 1
    nodes: Optional[torch.Tensor] = None        # (M,8) f32, see the module note
    leaf_tris: Optional[torch.Tensor] = None    # (L, 9, LEAF_SIZE) f32
    leaf_opaque: Optional[torch.Tensor] = None  # (L*LEAF_SIZE,) bool
    wide: Optional[torch.Tensor] = None         # (W, 32) f32, see the module note
    wide_depth: int = 0                         # levels of the wide tree

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes. x: (N,3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_bvh(vertices: np.ndarray, indices: np.ndarray, device="cuda") -> BVH:
    """Host-side numpy build; the heap arrays land on `device`. The kernel
    tables come from `attach`, which needs the scene."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n = indices.shape[0]

    p0 = vertices[indices[:, 0]]
    p1 = vertices[indices[:, 1]]
    p2 = vertices[indices[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    lo = centroid.min(0)
    extent = np.maximum(centroid.max(0) - lo, 1e-9)
    order = np.argsort(_morton3((centroid - lo) / extent), kind="stable")

    n_leaves = 1 << max(int(np.ceil(np.log2(max(n, 1) / LEAF_SIZE))), 0)
    cap = n_leaves * LEAF_SIZE
    tri_order = np.full(cap, -1, np.int32)
    tri_order[:n] = order.astype(np.int32)

    # Leaf AABBs over chunks (padding gets inverted boxes -> never hit).
    pad_min = np.full((cap - n, 3), BIG, np.float32)
    pad_max = np.full((cap - n, 3), -BIG, np.float32)
    smin = np.concatenate([tri_min[order], pad_min]).reshape(n_leaves, LEAF_SIZE, 3)
    smax = np.concatenate([tri_max[order], pad_max]).reshape(n_leaves, LEAF_SIZE, 3)
    leaf_min = smin.min(1)
    leaf_max = smax.max(1)

    # Internal AABBs bottom-up, level by level (heap layout).
    m = 2 * n_leaves - 1
    amin = np.empty((m, 3), np.float32)
    amax = np.empty((m, 3), np.float32)
    amin[n_leaves - 1:] = leaf_min
    amax[n_leaves - 1:] = leaf_max
    level_start = n_leaves - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        li = np.arange(parent_start, level_start)
        amin[li] = np.minimum(amin[2 * li + 1], amin[2 * li + 2])
        amax[li] = np.maximum(amax[2 * li + 1], amax[2 * li + 2])
        level_start = parent_start

    # Miss links: right sibling if the node is a left child, else the
    # parent's miss link (top-down, so parents are ready).
    miss = np.empty(m, np.int32)
    miss[0] = -1
    for i in range(1, m):
        miss[i] = i + 1 if (i % 2) == 1 else miss[(i - 1) // 2]

    def t(a):
        return torch.as_tensor(a, device=device)

    return BVH(aabb_min=t(amin), aabb_max=t(amax), miss_link=t(miss),
               tri_order=t(tri_order), n_internal=int(n_leaves - 1),
               n_leaves=int(n_leaves))


def wide_nodes(aabb_min: np.ndarray, aabb_max: np.ndarray, n_leaves: int):
    """The binary heap (boxes of its M = 2L-1 nodes) collapsed into the
    4-wide tree of the module note. Returns (records (W, 32) float32,
    levels)."""
    depth = n_leaves.bit_length() - 1      # binary levels below the root
    # binary level of each wide level: the root, then every second level
    # down to two above the leaves (an odd depth starts the pairs at 1)
    bin_levels = [0] + list(range(2 - depth % 2, depth - 1, 2))
    first = np.cumsum([0] + [2 ** lb for lb in bin_levels])   # wide index of each level
    n_wide = int(first[-1])
    lo = np.full((n_wide, WIDE, 3), BIG, np.float32)
    hi = np.full((n_wide, WIDE, 3), -BIG, np.float32)
    ref = np.full((n_wide, WIDE), EMPTY, np.int32)
    for w, lb in enumerate(bin_levels):
        pos = np.arange(2 ** lb)[:, None]
        node = 2 ** lb - 1 + pos
        if depth == 0:                      # the root is the only leaf
            level, kids = 0, node
        elif lb == 0 and depth % 2:         # the root of an odd depth: two children
            level, kids = 1, 2 * node + 1 + np.arange(2)
        else:                               # four grandchildren
            level, kids = lb + 2, 4 * node + 3 + np.arange(4)
        rows, width = first[w] + pos[:, 0], kids.shape[1]
        lo[rows, :width] = aabb_min[kids]
        hi[rows, :width] = aabb_max[kids]
        if level == depth:
            ref[rows, :width] = -1 - (kids - (n_leaves - 1))
        else:
            ref[rows, :width] = first[w + 1] + kids - (2 ** level - 1)
    # assembled as int32 bits, so the references pass through unchanged
    rec = np.zeros((n_wide, WIDE_RECORD), np.int32)
    boxes = np.concatenate([lo.transpose(0, 2, 1), hi.transpose(0, 2, 1)], 1)
    rec[:, 0:24] = boxes.reshape(n_wide, 24).view(np.int32)
    rec[:, 24:28] = ref
    return rec.view(np.float32), len(bin_levels)


def _kernel_tables(scene, bvh: BVH) -> BVH:
    """`bvh` with its nodes / leaf_tris / leaf_opaque tables (module note),
    on the scene's device; the heap fields become views of `nodes`."""
    dev = scene.device
    m = bvh.aabb_min.shape[0]
    miss_bits = bvh.miss_link.to(dev, torch.int32).view(torch.float32)
    nodes = torch.cat([bvh.aabb_min.to(dev), bvh.aabb_max.to(dev), miss_bits[:, None],
                       torch.zeros((m, 1), dtype=torch.float32, device=dev)], 1)
    nodes = nodes.contiguous()
    order = bvh.tri_order.to(dev).long()
    pad = (order < 0)[:, None]
    tri = scene.indices[order.clamp_min(0)].long()
    # a search input: the tables are constants, as the search is stopped
    v = scene.vertices.detach()
    p0 = v[tri[:, 0]]
    e1 = v[tri[:, 1]] - p0
    e2 = v[tri[:, 2]] - p0
    p0 = torch.where(pad, FAR, p0)
    e1 = torch.where(pad, 0.0, e1)
    e2 = torch.where(pad, 0.0, e2)
    opaque = scene.tri_opaque[order.clamp_min(0)] & ~pad[:, 0]
    wide, levels = wide_nodes(bvh.aabb_min.cpu().numpy(), bvh.aabb_max.cpu().numpy(),
                              bvh.n_leaves)
    return bvh.replace(
        wide=torch.as_tensor(wide, device=dev), wide_depth=levels,
        aabb_min=nodes[:, 0:3], aabb_max=nodes[:, 3:6],
        miss_link=nodes[:, 6].view(torch.int32), tri_order=bvh.tri_order.to(dev),
        nodes=nodes,
        leaf_tris=torch.cat([p0, e1, e2], 1).reshape(-1, LEAF_SIZE, 9)
        .transpose(1, 2).contiguous(),
        leaf_opaque=opaque.contiguous())


def attach(scene, bvh: BVH | None = None):
    """The scene with its stackless BVH (built here unless given) and the
    kernel tables. The JAX package's Morton-cluster tables feed only its
    TPU kernel and have no counterpart here."""
    if bvh is None:
        bvh = build_bvh(scene.vertices.cpu().numpy(), scene.indices.cpu().numpy(),
                        device=scene.device)
    return scene.replace(bvh=_kernel_tables(scene, bvh))
