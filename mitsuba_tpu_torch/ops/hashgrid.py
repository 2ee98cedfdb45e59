"""Uniform hash grid for photon and point queries (port of ops/hashgrid.py).

The replacement for the reference's balanced point kd-tree photon map
(include/mitsuba/render/photonmap.h:36): points are binned into a spatial
hash, sorted by cell hash (one stable argsort), and range queries walk the
27 neighbour cells with fixed-size windows into the sorted array.
Everything is dense and masked; hash collisions only add candidates that
the radius test rejects.

The hash is the JAX package's uint32 arithmetic, done in int64: each int32
cell coordinate wraps to uint32 as two's complement, every product is
reduced mod 2^32, so the hashes, the sort order and the candidates equal
the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_M32 = 0xFFFFFFFF


class HashGrid(NamedTuple):
    order: torch.Tensor        # (P,) int64 permutation sorting points by cell hash
    sorted_hash: torch.Tensor  # (P,) int32 cell hash per sorted point (table_size: invalid)
    cell_size: torch.Tensor    # () float32
    table_size: int


def _cell_hash(ix, iy, iz, table_size: int) -> torch.Tensor:
    """Spatial hash of int32 cell coordinates (Teschner et al. constants),
    as uint32 arithmetic: int32 tensor in [0, table_size)."""
    h = ((((ix.to(torch.int64) & _M32) * 73856093) & _M32)
         ^ (((iy.to(torch.int64) & _M32) * 19349663) & _M32)
         ^ (((iz.to(torch.int64) & _M32) * 83492791) & _M32))
    return (h % table_size).to(torch.int32)


def _cells(p: torch.Tensor, cell_size: torch.Tensor) -> torch.Tensor:
    return torch.floor(p / cell_size).to(torch.int32)


def build(pos: torch.Tensor, valid: torch.Tensor, cell_size, table_size: int = 1 << 18
          ) -> HashGrid:
    """Sort points by cell hash. Invalid points take the hash table_size, so
    they sort to the end and stay out of every query window."""
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32, device=pos.device)
    grid = _cells(pos, cell_size)
    h = _cell_hash(grid[:, 0], grid[:, 1], grid[:, 2], table_size)
    h = torch.where(valid, h, torch.full_like(h, table_size))
    # stable, as jnp.argsort: the points of a cell keep their order
    order = torch.argsort(h, stable=True)
    return HashGrid(order=order, sorted_hash=h[order], cell_size=cell_size,
                    table_size=table_size)


def query_sum(grid: HashGrid, pos: torch.Tensor, q: torch.Tensor, radius: torch.Tensor,
              reduce_fn, init, window: int = 64):
    """Accumulate over all points within `radius` (per query, (Q,)) of each
    query point. reduce_fn(carry, idx, mask) -> carry is called for (Q,
    window) blocks of candidate original point indices with a validity
    mask, once per neighbour cell; it gathers its own payloads.

    Each cell contributes up to `window` sorted candidates: points of a
    denser cell beyond the window are dropped (size the cell ~ the query
    radius). Returns (carry, truncated): the number of (query, cell) pairs
    that dropped candidates, an int64 tensor."""
    base = _cells(q, grid.cell_size)
    carry = init
    truncated = torch.zeros((), dtype=torch.int64, device=q.device)
    n = grid.order.shape[0]
    lanes = torch.arange(window, dtype=torch.int64, device=q.device)
    r2_max = (radius * radius)[:, None]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = _cell_hash(base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz,
                               grid.table_size)
                start = torch.searchsorted(grid.sorted_hash, h, right=False)
                end = torch.searchsorted(grid.sorted_hash, h, right=True)
                truncated = truncated + ((end - start) > window).sum()
                idx_w = start[:, None] + lanes[None, :]
                in_cell = idx_w < end[:, None]
                pidx = grid.order[torch.clamp_max(idx_w, n - 1)]    # (Q, W) original ids
                d = pos[pidx] - q[:, None, :]
                mask = in_cell & (torch.sum(d * d, dim=-1) <= r2_max)
                carry = reduce_fn(carry, pidx, mask)
    return carry, truncated
