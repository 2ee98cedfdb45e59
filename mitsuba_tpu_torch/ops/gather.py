"""Row gathers from small scene tables, `table[idx]`, with a deterministic
backward: the CUDA kernel pair of `csrc/gather_backward.cu` and its plain
PyTorch twin.

`table[idx]`'s own backward is `index_put_(accumulate=True)`, which on
the card sorts the indices and sums each run of equal rows serially. The
renderer's gradient leaves are tiny tables read by every lane (the
emitters' radiance, the bsdf reflectances, a small mesh's vertices and
what is built from them), so those runs are 10^5 to 10^6 long. The kernel
sums each warp's lanes of equal rows with a shuffle tree into per-warp
copies of the table's gradient in shared memory, then the copies in a
fixed order (see the .cu note). It replaces no TPU kernel: the JAX package
leaves this backward to XLA.

`gather_rows(table, idx)` returns what `table[idx]` returns and routes by
what it can observe:
  - grad enabled, `table.requires_grad`, float32 and at most CAP floats
    (rows x the trailing dimensions, which the kernel flattens into
    channels): the autograd Function `GatherRows`, whose forward is the
    plain gather and whose backward launches the kernel for a CUDA table
    and runs the plain twin, `zeros.index_put_((idx,), grad,
    accumulate=True)` (the arithmetic of PyTorch's own backward, so a CPU
    table gets the same bits as through `table[idx]`), for a CPU one;
  - a table that requires grad but is larger than CAP, or not float32:
    plain `table[idx]`, counted in ROUTED_PLAIN (where the mechanism could
    have engaged and did not);
  - anything else (no grad): plain `table[idx]`, uncounted.
`idx` may be int32 or int64, of any shape. The backward is
once-differentiable: nothing in the port takes a double backward.

Counters, as the trace kernels': KERNEL_LAUNCHES["backward"] and
KERNEL_LANES["backward"] (lanes handed to the kernel) at each backward
launch, PLAIN_CALLS["backward"] at each run of the twin.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

# The largest rows x channels of a table whose gather backward the kernel
# takes: its 8 warps' private copies of the gradient fill 48 KB of shared
# memory (csrc/gather_backward.cu, MAX_FLOATS).
CAP = 1536

KERNEL_LAUNCHES = {"backward": 0}
KERNEL_LANES = {"backward": 0}
PLAIN_CALLS = {"backward": 0}
ROUTED_PLAIN = {"over_cap": 0, "dtype": 0}


def reset_counts():
    for counts in (KERNEL_LAUNCHES, KERNEL_LANES, PLAIN_CALLS, ROUTED_PLAIN):
        for k in counts:
            counts[k] = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]`: the same values, shape and dtype; its backward, where
    the table requires grad and is small, by the kernel or its twin."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    if table.numel() > CAP:
        ROUTED_PLAIN["over_cap"] += 1
        return table[idx]
    if table.dtype != torch.float32:
        ROUTED_PLAIN["dtype"] += 1
        return table[idx]
    return GatherRows.apply(table, idx)


class GatherRows(torch.autograd.Function):
    """out = table[idx]; d table = the rows of d out summed by index."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return gather_backward(grad, idx, ctx.table_shape), None


def gather_backward_plain(grad, idx, table_shape):
    """The twin: PyTorch's own backward of table[idx]."""
    return grad.new_zeros(table_shape).index_put_((idx,), grad, accumulate=True)


def gather_backward(grad, idx, table_shape):
    """The gradient of `table` (of `table_shape`) from the gradient of
    table[idx]: the kernel for a CUDA tensor, the twin for a CPU one."""
    if grad.device.type == "cpu":
        PLAIN_CALLS["backward"] += 1
        return gather_backward_plain(grad, idx, table_shape)
    rows = table_shape[0]
    c = 1
    for s in table_shape[1:]:
        c *= s
    n = idx.numel()
    if grad.dtype != torch.float32 or idx.dtype not in (torch.int32, torch.int64) \
            or idx.device != grad.device or tuple(grad.shape) != (*idx.shape, *table_shape[1:]):
        raise ValueError(
            f"gather backward: grad must be float32 of shape idx.shape + {tuple(table_shape[1:])}"
            f" on the index's device, got {grad.dtype} {tuple(grad.shape)} on {grad.device} for"
            f" {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    if rows * c > CAP:
        raise ValueError(f"gather backward: table of {rows * c} floats, above the cap {CAP}")
    out = torch.empty(table_shape, dtype=torch.float32, device=grad.device)
    if n == 0 or rows * c == 0:
        return out.zero_()
    g = grad.reshape(n, c).contiguous()
    ix = idx.reshape(n).contiguous()
    lib = _lib()
    blocks = lib.gather_backward_blocks(n)
    partial = torch.empty((blocks, rows * c), dtype=torch.float32, device=grad.device)
    with torch.cuda.device(grad.device):
        KERNEL_LAUNCHES["backward"] += 1
        KERNEL_LANES["backward"] += n
        rc = lib.gather_backward(g.data_ptr(), ix.data_ptr(), ix.element_size(), n, rows, c,
                                 partial.data_ptr(), blocks, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather backward kernel: CUDA error {rc} at launch")
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (at first use) and bind the kernel library."""
    from .. import _build

    lib = ctypes.CDLL(str(_build.build("gather_backward")))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_backward_blocks.argtypes = [I64]
    lib.gather_backward_blocks.restype = I32
    lib.gather_backward_max_floats.argtypes = []
    lib.gather_backward_max_floats.restype = I32
    lib.gather_backward.argtypes = [P, P, I32, I64, I32, I32, P, I32, P, P]
    lib.gather_backward.restype = I32
    if lib.gather_backward_max_floats() != CAP:
        raise RuntimeError("gather backward: the library's MAX_FLOATS is not ops/gather.CAP")
    return lib
