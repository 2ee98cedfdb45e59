"""mitsuba_tpu_torch — the PyTorch + CUDA port of mitsuba_tpu.

The package mirrors `mitsuba_tpu/` module by module (core, scene, models,
ops, integrators) so each function's JAX counterpart sits at the same path.
The JAX package is the reference; this one imports torch and never jax.

Rendering is primal only for now, and the brute-force ray-triangle search
runs a hand-written CUDA kernel on the GPU (`ops/brute_kernel.py`,
`csrc/brute_intersect.cu`) with a plain PyTorch twin on the CPU.
"""

import torch

__version__ = "0.1.0"

# The whole renderer works in float32, and the camera's ray rotation is the
# only matmul on its path: TF32 would keep ~10 mantissa bits of it and move
# every ray, so both TF32 switches stay off for any caller of the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
