"""mitsuba_tpu_torch — the PyTorch + CUDA port of mitsuba_tpu.

The package mirrors `mitsuba_tpu/` module by module (core, scene, models,
ops, integrators) so each function's JAX counterpart sits at the same path.
The JAX package is the reference; this one imports torch and never jax.

The ray-triangle searches run hand-written CUDA kernels on the GPU
(`ops/brute_kernel.py` + `csrc/brute_intersect.cu`, `ops/bvh_kernel.py` +
`csrc/bvh_intersect.cu`) with plain PyTorch twins on the CPU. Renders are
differentiable with autograd: the searches are detached, and gradients
reach the geometry through the recomputed hit and the edge-sampled
boundary terms (`integrators/boundary.py`, `integrators/reparam.py`).

`python -m mitsuba_tpu_torch scene.xml -o out.exr` renders a Mitsuba 0.6
scene file on the card (`cli.py`, `scene/xml.py`; `--cpu` for the CPU).
"""

import torch

__version__ = "0.1.0"

# The whole renderer works in float32, and the camera's ray rotation is the
# only matmul on its path: TF32 would keep ~10 mantissa bits of it and move
# every ray, so both TF32 switches stay off for any caller of the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
