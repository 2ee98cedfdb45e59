"""Flattened scene IR: triangle soup + SoA material/emitter tables (port
of scene/ir.py).

The scene is a dataclass of tensors. The static fields (`num_triangles`,
`bsdf_families`, `has_env`, `has_area`, `has_null`, `has_perturb`,
`has_vtx_colors`, `has_wireframe`, `group_probs`) stay plain Python, as they are static pytree fields in the
JAX package. `bvh` holds the stackless BVH of big meshes (scene/bvh.py;
None until `bvh.attach`), `envmap` a lat-long environment
(scene/envmap.py; None for a constant one), `occupancy` the occupancy map
of approximate shadow rays (ops/occupancy.py; None until
`occupancy.attach`), `cloth` the woven-cloth weave tables
(models/cloth.ClothTables; None without Irawan materials). Bitmap
textures live in one padded stack with their mip strip (built where
`lod_scale` is given); vertex colours and wireframe materials are not
ported.

Gradients: the float leaves that may carry `requires_grad` (set through
`replace()`, as the JAX tests differentiate them) are `vertices` (hit
points, normals, emitter samples and the boundary terms' edge points),
`materials.reflectance`, `materials.alpha` (roughness), `textures` (texel
lookups), `envmap.image`, `emitters.radiance` and the medium's `sigma_t`,
`albedo` and `g` (models/medium.py). Every other leaf, and
the derived tables (`edge_table`, `face_adj`, the emitter and envmap CDFs
and pdfs, the mip strip, `tri_uv_density`, a `bvh`), is a constant built
at scene assembly: moving `vertices` or `textures` leaves them at their
build-time values, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.gather import gather_rows

# BSDF type codes (same values as the JAX package)
BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_DIELECTRIC = 4
BSDF_ROUGH_DIELECTRIC = 5
BSDF_PLASTIC = 6
BSDF_ROUGH_PLASTIC = 7
BSDF_PHONG = 8
BSDF_THIN_DIELECTRIC = 9
BSDF_ROUGH_DIFFUSE = 10
BSDF_WARD = 11
BSDF_MASK = 12
BSDF_TWO_SIDED = 13
BSDF_BLEND = 14
BSDF_DIFFUSE_TRANSMITTER = 15
BSDF_COATING = 16
BSDF_HK = 17
BSDF_IRAWAN = 18

BSDF_NAMES = {v: k[5:].lower() for k, v in list(globals().items())
              if k.startswith("BSDF_")}

# microfacet distribution codes (extra[3] of microfacet families)
MICROFACET_BECKMANN = 0
MICROFACET_GGX = 1

# texture ids below 0: a constant colour from the table, except the two
# procedural per-interaction textures
TEX_NONE = -1
TEX_VERTEXCOLOR = -2   # barycentric per-vertex colours (vertexcolors.cpp)
TEX_WIREFRAME = -3     # edge highlight from the barycentrics (wireframe.cpp)


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def detach(self):
        """A copy whose tensor leaves (nested tables included) are detached
        from autograd: the constant view of a scene that code paths with
        stopped gradients work on."""
        changes = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            if isinstance(x, (torch.Tensor, _Replace)):
                changes[f.name] = x.detach()
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Materials(_Replace):
    """SoA BSDF table; see the JAX package's Materials for the layout."""

    type: torch.Tensor             # (M,) int32 BSDF_* code
    reflectance: torch.Tensor      # (M,3)
    specular: torch.Tensor         # (M,3)
    eta: torch.Tensor              # (M,3)
    k: torch.Tensor                # (M,3)
    alpha: torch.Tensor            # (M,2)
    extra: torch.Tensor            # (M,4)
    tex_reflectance: torch.Tensor  # (M,) int32
    nested: torch.Tensor           # (M,2) int32
    tex_perturb: torch.Tensor      # (M,) int32
    perturb_kind: torch.Tensor     # (M,) int32

    @staticmethod
    def stack(records: list[dict], device) -> "Materials":
        n = max(len(records), 1)

        def col(key, width, default):
            out = np.tile(np.asarray(default, np.float32), (n, 1))
            for i, r in enumerate(records):
                if key in r:
                    out[i] = np.broadcast_to(np.asarray(r[key], np.float32), (width,))
            return torch.as_tensor(out, device=device)

        types = np.full((n,), BSDF_DIFFUSE, np.int32)
        texr = np.full((n,), TEX_NONE, np.int32)
        nested = np.full((n, 2), -1, np.int32)
        texp = np.full((n,), TEX_NONE, np.int32)
        pkind = np.zeros((n,), np.int32)
        for i, r in enumerate(records):
            types[i] = r.get("type", BSDF_DIFFUSE)
            texr[i] = r.get("tex_reflectance", TEX_NONE)
            nested[i] = r.get("nested", (-1, -1))
            texp[i] = r.get("tex_perturb", TEX_NONE)
            pkind[i] = r.get("perturb_kind", 0)

        def t(a):
            return torch.as_tensor(a, device=device)

        return Materials(
            type=t(types),
            reflectance=col("reflectance", 3, [0.5, 0.5, 0.5]),
            specular=col("specular", 3, [1.0, 1.0, 1.0]),
            eta=col("eta", 3, [1.5, 1.5, 1.5]),
            k=col("k", 3, [0.0, 0.0, 0.0]),
            alpha=col("alpha", 2, [0.1, 0.1]),
            extra=col("extra", 4, [0.0, 0.0, 0.0, 0.0]),
            tex_reflectance=t(texr),
            nested=t(nested),
            tex_perturb=t(texp),
            perturb_kind=t(pkind),
        )


@dataclasses.dataclass
class AreaEmitters(_Replace):
    """Area emitter table + triangle sampling distribution."""

    radiance: torch.Tensor         # (E,3)
    tri_index: torch.Tensor        # (ET,) int32
    tri_emitter: torch.Tensor      # (ET,) int32
    tri_cdf: torch.Tensor          # (ET,) inclusive CDF
    tri_pdf: torch.Tensor          # (ET,)
    select_pdf_full: torch.Tensor  # (T,) selection prob per scene triangle


@dataclasses.dataclass
class DeltaEmitters(_Replace):
    """Point, spot and directional emitters (and collimated beams, which
    only light-path sampling reaches). NEE is their only strategy: a BSDF
    sample never hits one, so their MIS weight is 1.

    kind (K,) int32 DELTA_*; position (K,3); direction (K,3) emission
    direction (spot, directional); intensity (K,3): radiant intensity for
    point and spot, irradiance for directional; cutoff (K,2): spot
    (cos cutoffAngle, cos beamWidth)."""

    kind: torch.Tensor
    position: torch.Tensor
    direction: torch.Tensor
    intensity: torch.Tensor
    cutoff: torch.Tensor


DELTA_POINT = 0
DELTA_SPOT = 1
DELTA_DIRECTIONAL = 2
DELTA_COLLIMATED = 3


def build_delta_emitters(records: list, device="cuda") -> DeltaEmitters:
    """records: dicts with kind, position, direction, intensity and, for a
    spot, cutoff_deg and beam_deg (default 20 and 0.75 x cutoff)."""
    k = len(records)
    kind = np.zeros((k,), np.int32)
    pos = np.zeros((k, 3), np.float32)
    dirn = np.tile(np.asarray([0, 0, 1], np.float32), (k, 1))
    inten = np.ones((k, 3), np.float32)
    cut = np.tile(np.asarray([np.cos(np.deg2rad(20.0)), np.cos(np.deg2rad(15.0))],
                             np.float32), (k, 1))
    for i, r in enumerate(records):
        kind[i] = r.get("kind", DELTA_POINT)
        pos[i] = np.asarray(r.get("position", (0, 0, 0)), np.float32)
        d = np.asarray(r.get("direction", (0, 0, 1)), np.float32)
        dirn[i] = d / max(np.linalg.norm(d), 1e-12)
        inten[i] = np.broadcast_to(np.asarray(r.get("intensity", 1.0), np.float32), (3,))
        if "cutoff_deg" in r or "beam_deg" in r:
            co = float(r.get("cutoff_deg", 20.0))
            bw = float(r.get("beam_deg", co * 0.75))
            cut[i] = (np.cos(np.deg2rad(co)), np.cos(np.deg2rad(bw)))

    def t(a):
        return torch.as_tensor(a, device=device)

    return DeltaEmitters(kind=t(kind), position=t(pos), direction=t(dirn),
                         intensity=t(inten), cutoff=t(cut))


@dataclasses.dataclass
class Scene(_Replace):
    """The whole flattened scene."""

    vertices: torch.Tensor      # (V,3)
    indices: torch.Tensor       # (T,3) int32
    face_adj: torch.Tensor      # (T,3) int32 neighbour across edge slot k, -1 open
    edge_table: torch.Tensor    # (E,5) int32 unique edges: v0, v1, face, nbr, opp
    normals: torch.Tensor       # (V,3) shading normals
    uvs: torch.Tensor           # (V,2)
    tri_material: torch.Tensor  # (T,) int32
    tri_emitter: torch.Tensor   # (T,) int32, -1 if not emissive
    tri_opaque: torch.Tensor    # (T,) bool: False for null-BSDF triangles
    materials: Materials
    emitters: AreaEmitters
    env_radiance: torch.Tensor  # (3,) constant environment
    # texture stack (K, TH, TW, 3), padded; (1,1,1,3) zeros = no textures
    textures: torch.Tensor
    tex_size: torch.Tensor      # (K,2) int32 actual (h, w) of each texture
    tex_transform: torch.Tensor  # (K,4) uv scale_u, scale_v, offset_u, offset_v
    tex_nearest: torch.Tensor   # (K,) int32 1 = nearest (procedural grids)
    # mip strip: levels 1..L box-downsampled side by side in one
    # (K, TH//2, TW, 3) canvas, level l at x offset TW (1 - 2^(1-l)) with
    # size (TH>>l, TW>>l); None = no mips
    tex_mips: Optional[torch.Tensor] = None
    # (T,) per-triangle texel density sqrt(uv area / world area) x lod_scale
    tri_uv_density: Optional[torch.Tensor] = None
    envmap: object = None       # scene/envmap.EnvMap; None = constant env
    medium: object = None       # models/medium.Medium filling space; None = vacuum
    delta_emitters: Optional[DeltaEmitters] = None
    vertex_colors: Optional[torch.Tensor] = None  # (V,3) for TEX_VERTEXCOLOR
    # (7,) wireframe: interior rgb, edge rgb, line width in barycentric units
    wire_params: Optional[torch.Tensor] = None
    # ops/occupancy.OccupancyMap for approximate shadow rays; None = exact
    occupancy: object = None
    # models/cloth.ClothTables of the BSDF_IRAWAN materials; None = no cloth
    cloth: object = None

    # static metadata
    group_probs: tuple = ()
    num_triangles: int = 0
    bsdf_families: tuple = ()
    has_env: bool = False
    has_area: bool = True
    has_null: bool = False
    # a material carries a normal or bump map (surface_interaction perturbs)
    has_perturb: bool = False
    # procedural per-interaction textures present (surface_interaction
    # computes them only then)
    has_vtx_colors: bool = False
    has_wireframe: bool = False
    bvh: object = None  # scene/bvh.BVH, set by bvh.attach

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def tri_vertices(self):
        """Returns (p0, e1, e2): (T,3) base vertex and edge vectors."""
        v = self.vertices
        i = self.indices
        p0 = gather_rows(v, i[:, 0])
        e1 = gather_rows(v, i[:, 1]) - p0
        e2 = gather_rows(v, i[:, 2]) - p0
        return p0, e1, e2


def edge_tables(indices: np.ndarray):
    """(face_adj (T,3), edge_table (E,5)) of an int32 (T,3) index array,
    built as the JAX package builds them (ir.py:507-537).

    face_adj[f, k] is the face across edge slot k of face f, the edge
    (indices[f,k], indices[f,(k+1)%3]), or -1 for an open edge. edge_table
    lists each undirected edge once (an open edge, or the slot of the lower
    face of a shared pair) as (v0, v1, owning face, neighbour face or -1,
    the owning face's vertex opposite the edge)."""
    T = indices.shape[0]
    edge_v = np.stack([indices[:, [0, 1]], indices[:, [1, 2]],
                       indices[:, [2, 0]]], axis=1).reshape(-1, 2)
    ekey = np.sort(edge_v, axis=1)
    order = np.lexsort((ekey[:, 1], ekey[:, 0]))
    sk = ekey[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    face_adj_flat = np.full((3 * T,), -1, np.int32)
    a = order[:-1][same]
    b = order[1:][same]
    face_adj_flat[a] = b // 3
    face_adj_flat[b] = a // 3

    slot_face = np.repeat(np.arange(T, dtype=np.int32), 3)
    keep = (face_adj_flat < 0) | (slot_face < face_adj_flat)
    slot_in_face = np.tile(np.arange(3, dtype=np.int32), T)
    opp_vert = indices[slot_face, (slot_in_face + 2) % 3]
    edge_table = np.stack(
        [edge_v[keep, 0], edge_v[keep, 1], slot_face[keep],
         face_adj_flat[keep], opp_vert[keep]], axis=1).astype(np.int32)
    return face_adj_flat.reshape(T, 3), edge_table


def build_scene(
    vertices: np.ndarray,
    indices: np.ndarray,
    tri_material: np.ndarray,
    materials: list[dict],
    tri_radiance: Optional[dict] = None,
    normals: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    env_radiance=None,
    textures: Optional[list] = None,
    vertex_colors: Optional[np.ndarray] = None,
    wire_params=None,
    lod_scale: Optional[float] = None,
    device="cuda",
) -> Scene:
    """Host-side scene assembly in numpy, then one copy to `device`.

    textures: dicts with "data" (H, W[, 3]) and optional "transform" (uv
    scale and offset) and "nearest"; lod_scale (the world width of a pixel
    at unit distance) builds the mip strip and the per-triangle uv density
    that drive trilinear and EWA lookups. vertex_colors (V,3) and
    wire_params (7,) feed the TEX_VERTEXCOLOR and TEX_WIREFRAME
    reflectance textures."""
    def t(a):
        return torch.as_tensor(a, device=device)

    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    T = indices.shape[0]
    tri_material = np.asarray(tri_material, np.int32)

    if normals is None:
        # area-weighted vertex normals
        p0 = vertices[indices[:, 0]]
        fn = np.cross(vertices[indices[:, 1]] - p0, vertices[indices[:, 2]] - p0)
        normals = np.zeros_like(vertices)
        for k in range(3):
            np.add.at(normals, indices[:, k], fn)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(lens, 1e-20)
    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), np.float32)

    tri_emitter = np.full((T,), -1, np.int32)
    em_radiance, em_tris, em_emitter = [], [], []
    if tri_radiance:
        # group contiguous identical radiances into one emitter each
        rad_key = {}
        for tri, rad in sorted(tri_radiance.items()):
            key = tuple(np.asarray(rad, np.float32).reshape(3))
            if key not in rad_key:
                rad_key[key] = len(em_radiance)
                em_radiance.append(np.asarray(key, np.float32))
            e = rad_key[key]
            tri_emitter[tri] = e
            em_tris.append(tri)
            em_emitter.append(e)

    if em_tris:
        em_tris_np = np.asarray(em_tris, np.int32)
        em_emitter_np = np.asarray(em_emitter, np.int32)
        em_rad_np = np.stack(em_radiance)
        p0 = vertices[indices[em_tris_np, 0]]
        e1 = vertices[indices[em_tris_np, 1]] - p0
        e2 = vertices[indices[em_tris_np, 2]] - p0
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        # weight by area x luminance
        lum = em_rad_np[em_emitter_np] @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        w = areas * np.maximum(lum, 1e-12)
        pdf = w / w.sum()
        cdf = np.cumsum(pdf).astype(np.float32)
        cdf[-1] = 1.0
        select_full = np.zeros((T,), np.float32)
        select_full[em_tris_np] = pdf
        emitters = AreaEmitters(
            radiance=t(em_rad_np),
            tri_index=t(em_tris_np),
            tri_emitter=t(em_emitter_np),
            tri_cdf=t(cdf),
            tri_pdf=t(pdf.astype(np.float32)),
            select_pdf_full=t(select_full),
        )
    else:
        emitters = AreaEmitters(
            radiance=t(np.zeros((1, 3), np.float32)),
            tri_index=t(np.zeros((1,), np.int32)),
            tri_emitter=t(np.zeros((1,), np.int32)),
            tri_cdf=t(np.ones((1,), np.float32)),
            tri_pdf=t(np.ones((1,), np.float32)),
            select_pdf_full=t(np.zeros((T,), np.float32)),
        )

    families = tuple(sorted({int(r.get("type", BSDF_DIFFUSE)) for r in materials}))
    has_env = env_radiance is not None
    env = np.asarray(env_radiance if has_env else [0.0, 0.0, 0.0], np.float32)

    mat_types = np.asarray(
        [int(r.get("type", BSDF_DIFFUSE)) for r in materials] or [BSDF_DIFFUSE],
        np.int32)
    tri_opaque = mat_types[np.clip(tri_material, 0, len(mat_types) - 1)] \
        != BSDF_NULL

    face_adj, edge_table = edge_tables(indices)
    tex = texture_tables(textures, lod_scale)
    uv_density = None
    if lod_scale is not None:
        uv_density = uv_densities(vertices, indices, np.asarray(uvs, np.float32), lod_scale)

    return Scene(
        vertices=t(vertices),
        indices=t(indices),
        face_adj=t(face_adj),
        edge_table=t(edge_table),
        normals=t(normals.astype(np.float32)),
        uvs=t(uvs.astype(np.float32)),
        tri_material=t(tri_material),
        tri_emitter=t(tri_emitter),
        tri_opaque=t(tri_opaque),
        materials=Materials.stack(materials, device),
        emitters=emitters,
        env_radiance=t(env),
        **{k: None if v is None else t(v) for k, v in tex.items()},
        tri_uv_density=None if uv_density is None else t(uv_density),
        vertex_colors=(None if vertex_colors is None
                       else t(np.asarray(vertex_colors, np.float32))),
        wire_params=None if wire_params is None else t(np.asarray(wire_params, np.float32)),
        has_vtx_colors=vertex_colors is not None,
        has_wireframe=wire_params is not None,
        num_triangles=int(T),
        bsdf_families=families,
        has_env=bool(has_env),
        has_area=bool(em_tris),
        has_null=bool((~tri_opaque).any()),
        has_perturb=any(int(r.get("perturb_kind", 0)) != 0 for r in materials),
    )


def _rgb(data):
    d = np.asarray(data, np.float32)
    if d.ndim == 2:
        d = np.repeat(d[..., None], 3, axis=-1)
    return d[..., :3]


def texture_tables(textures: Optional[list], lod_scale: Optional[float]) -> dict:
    """The texture stack and its tables as numpy, built as the JAX package
    builds them (ir.py:438-486): `textures`, `tex_size`, `tex_transform`,
    `tex_nearest`, and `tex_mips`, the mip strip, where lod_scale is given
    and the stack is at least 4x4."""
    if not textures:
        return dict(textures=np.zeros((1, 1, 1, 3), np.float32),
                    tex_size=np.ones((1, 2), np.int32),
                    tex_transform=np.asarray([[1.0, 1.0, 0.0, 0.0]], np.float32),
                    tex_nearest=np.zeros((1,), np.int32), tex_mips=None)
    th = max(int(np.shape(t["data"])[0]) for t in textures)
    tw = max(int(np.shape(t["data"])[1]) for t in textures)
    k = len(textures)
    stack = np.zeros((k, th, tw, 3), np.float32)
    sizes = np.zeros((k, 2), np.int32)
    xforms = np.zeros((k, 4), np.float32)
    nearest = np.zeros((k,), np.int32)
    for i, t in enumerate(textures):
        d = _rgb(t["data"])
        stack[i, :d.shape[0], :d.shape[1]] = d
        sizes[i] = d.shape[:2]
        xforms[i] = np.asarray(t.get("transform", (1.0, 1.0, 0.0, 0.0)), np.float32)
        nearest[i] = 1 if t.get("nearest", False) else 0
    strip = None
    if lod_scale is not None and min(th, tw) >= 4:
        # per-texture box-downsampled chains, level l >= 1 at x = tw (1 - 2^(1-l))
        strip = np.zeros((k, th // 2, tw, 3), np.float32)
        for i, t in enumerate(textures):
            lvl = _rgb(t["data"])
            x_off = 0
            while min(lvl.shape[0], lvl.shape[1]) >= 2:
                hh, ww = lvl.shape[0] // 2, lvl.shape[1] // 2
                lvl = lvl[:hh * 2, :ww * 2].reshape(hh, 2, ww, 2, 3).mean((1, 3))
                if x_off + ww > tw or hh > th // 2:
                    break
                strip[i, :hh, x_off:x_off + ww] = lvl
                x_off += ww
    return dict(textures=stack, tex_size=sizes, tex_transform=xforms,
                tex_nearest=nearest, tex_mips=strip)


def uv_densities(vertices, indices, uvs, lod_scale) -> np.ndarray:
    """(T,) texel density sqrt(uv area / world area) x lod_scale: the mip
    footprint's per-triangle factor (JAX ir.py:488-500)."""
    p0 = vertices[indices[:, 0]]
    area_w = 0.5 * np.linalg.norm(np.cross(vertices[indices[:, 1]] - p0,
                                           vertices[indices[:, 2]] - p0), axis=1)
    t0 = uvs[indices[:, 0]]
    e1u = uvs[indices[:, 1]] - t0
    e2u = uvs[indices[:, 2]] - t0
    area_u = 0.5 * np.abs(e1u[:, 0] * e2u[:, 1] - e1u[:, 1] * e2u[:, 0])
    return (np.sqrt(area_u / np.maximum(area_w, 1e-20))
            * np.float32(lod_scale)).astype(np.float32)


_OPTIONAL = ("tex_mips", "tri_uv_density", "vertex_colors", "wire_params")


def _leaf(x, device):
    # np.array copies: the leaves of a jax array are read-only buffers
    return torch.as_tensor(np.array(x), device=device)


def _tensor_fields(cls, src, device):
    return {f.name: _leaf(getattr(src, f.name), device)
            for f in dataclasses.fields(cls)}


def from_jax(jscene, device="cuda") -> Scene:
    """Carry a JAX package Scene across: each leaf goes through
    `np.array` (so `jscene` may hold jax or numpy arrays) and the static
    fields are copied. A JAX `bvh` comes across leaf by leaf, with the
    port's kernel tables added; its `clusters` (the TPU kernel's private
    table) are dropped, and need a `bvh` beside them. The texture stack,
    its mip strip, an `envmap`, a `medium` (its kind, phase and
    phase_params stay Python values), the `delta_emitters`, `vertex_colors`
    and `wire_params` come across as they are, and so do an occupancy
    map (ops/occupancy.py) and the woven-cloth tables (models/cloth.py)."""
    jbvh = getattr(jscene, "bvh", None)
    if getattr(jscene, "clusters", None) is not None and jbvh is None:
        raise NotImplementedError("from_jax: scene.clusters without a bvh: the "
                                  "port walks the BVH and has no cluster tables")
    fields = {}
    for f in dataclasses.fields(Scene):
        if f.name == "bvh" or f.name in fields:
            continue
        if f.name in ("face_adj", "edge_table") and getattr(jscene, f.name, None) is None:
            # a JAX scene assembled without them: build both here
            fields["face_adj"], fields["edge_table"] = (
                _leaf(a, device) for a in edge_tables(np.array(jscene.indices, np.int32)))
            continue
        if f.name == "materials":
            fields[f.name] = Materials(**_tensor_fields(Materials, jscene.materials, device))
        elif f.name == "emitters":
            fields[f.name] = AreaEmitters(**_tensor_fields(AreaEmitters, jscene.emitters, device))
        elif f.name == "envmap":
            fields[f.name] = None if jscene.envmap is None else _envmap_from_jax(
                jscene.envmap, device)
        elif f.name == "medium":
            fields[f.name] = None if jscene.medium is None else _medium_from_jax(
                jscene.medium, device)
        elif f.name == "occupancy":
            om = getattr(jscene, "occupancy", None)
            fields[f.name] = None if om is None else _occupancy_from_jax(om, device)
        elif f.name == "cloth":
            jc = getattr(jscene, "cloth", None)
            fields[f.name] = None if jc is None else _cloth_from_jax(jc, device)
        elif f.name == "delta_emitters":
            de = jscene.delta_emitters
            fields[f.name] = None if de is None else DeltaEmitters(
                **_tensor_fields(DeltaEmitters, de, device))
        elif f.name in _OPTIONAL:
            x = getattr(jscene, f.name)
            fields[f.name] = None if x is None else _leaf(x, device)
        elif f.type in ("tuple", "int", "bool"):
            fields[f.name] = getattr(jscene, f.name)
        else:
            fields[f.name] = _leaf(getattr(jscene, f.name), device)
    fields["group_probs"] = tuple(float(p) for p in fields["group_probs"])
    fields["bsdf_families"] = tuple(int(b) for b in fields["bsdf_families"])
    scene = Scene(**fields)
    if jbvh is None:
        return scene
    from . import bvh as bvhlib

    return bvhlib.attach(scene, bvhlib.BVH(
        aabb_min=_leaf(jbvh.aabb_min, device), aabb_max=_leaf(jbvh.aabb_max, device),
        miss_link=_leaf(jbvh.miss_link, device), tri_order=_leaf(jbvh.tri_order, device),
        n_internal=int(jbvh.n_internal), n_leaves=int(jbvh.n_leaves)))


def _envmap_from_jax(jem, device):
    from .envmap import EnvMap

    spectral = getattr(jem, "spectral", None)
    return EnvMap(image=_leaf(jem.image, device), row_cdf=_leaf(jem.row_cdf, device),
                  cond_cdf=_leaf(jem.cond_cdf, device), pdf_map=_leaf(jem.pdf_map, device),
                  scale=_leaf(jem.scale, device),
                  spectral=None if spectral is None else _leaf(spectral, device))


def _occupancy_from_jax(jom, device):
    from ..ops.occupancy import OccupancyMap

    return OccupancyMap(grid=_leaf(jom.grid, device), box_min=_leaf(jom.box_min, device),
                        inv_extent=_leaf(jom.inv_extent, device), res=int(jom.res))


def _cloth_from_jax(jcloth, device):
    from ..models.cloth import ClothTables

    return ClothTables(*(_leaf(getattr(jcloth, f), device) for f in ClothTables._fields))


def _medium_from_jax(jmed, device):
    from ..models.medium import Medium

    fields = {}
    for f in dataclasses.fields(Medium):
        x = getattr(jmed, f.name)
        if f.name == "phase_params":
            fields[f.name] = tuple(float(v) for v in x)
        elif f.name in ("kind", "phase"):
            fields[f.name] = int(x)
        else:
            fields[f.name] = None if x is None else _leaf(x, device)
    return Medium(**fields)
