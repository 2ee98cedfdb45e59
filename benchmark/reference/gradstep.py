"""The plain reference's inverse-rendering steps, and the numbers that decide
whether the program's first steps are correct. It imports nothing of the
renderer under test, and not torch.optim: its Adam is written out here.

A step renders the start scene with the current bsdf reflectances and
emitter radiances (`reference/pathtracer.py`, differentiable in both),
takes the L2 loss (the mean over pixels and channels of the squared gap)
to a target image of the target scene, and moves both with Adam
(Kingma and Ba; bias-corrected moments, as torch.optim.Adam's defaults).
Each step draws new samples. The vertices are held fixed: their gradient
carries visibility-boundary terms that this path tracer does not estimate.

The numbers (`numbers`), each a share:
- loss_gap: the largest over the steps of |L_program - L_ref| / L_ref;
- grad_gap: the worst compared leaf's |g_program - g_ref| over the larger
  of g_ref and the median compared leaf's g_ref, where g is the norm of
  the first step's gradient as Adam received it (its first moment after
  one step over (1 - beta1));
- change_gap: the same of the norm of each leaf's change after the steps.
A leaf whose reference gradient is under a thousandth of the median
leaf's is not compared (it moves by round-off alone).
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from . import pathtracer

LEAVES = ("reflectance", "radiance")
NEGLIGIBLE = 1e-3


class Adam:
    """Adam over a dict of leaves, each with its own learning rate."""

    def __init__(self, leaves: dict, lrs: dict, betas, eps):
        self.leaves, self.lrs = leaves, lrs
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        for k, p in self.leaves.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lrs[k] * m_hat / (v_hat.sqrt() + self.eps))
            p.grad = None

    def first_gradient(self, k) -> torch.Tensor:
        """The gradient of the first step, from the first moment after it."""
        return self.m[k] / (1 - self.b1)


def steps(start, target, traffic: dict, seed: int, device, dtype=torch.float32) -> dict:
    """`traffic["check_steps"]` steps of the reference from `start`'s
    reflectances and radiances against its own `target_spp` render of
    `target` (both `reference/scene.Scene`), in `dtype`. Returns
    {"losses": [...], "first_grad": {leaf: norm}, "change": {leaf: norm}}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    with torch.no_grad():
        goal = pathtracer.Renderer(target, device, dtype).image_tensor(traffic["target_spp"], gen)
    init = {"reflectance": start.materials, "radiance": start.radiances}
    leaves = {k: torch.as_tensor(np.asarray(init[k], np.float32), device=device).to(dtype)
              .requires_grad_(True) for k in LEAVES}
    first = {k: v.detach().clone() for k, v in leaves.items()}
    opt = Adam(leaves, {k: traffic["lr"][k] for k in LEAVES}, traffic["betas"], traffic["eps"])
    losses, first_grad = [], {}
    for k in range(traffic["check_steps"]):
        r = pathtracer.Renderer(start, device, dtype, materials=leaves["reflectance"],
                                radiances=leaves["radiance"])
        img = r.image_tensor(traffic["spp"], gen)
        loss = ((img - goal) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if k == 0:
            first_grad = {n: float(opt.first_gradient(n).float().norm()) for n in LEAVES}
    change = {n: float((leaves[n].detach() - first[n]).float().norm()) for n in LEAVES}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _worst_leaf(program: dict, reference: dict, ref_grad: dict) -> float:
    median = statistics.median(ref_grad[k] for k in LEAVES)
    kept = [k for k in LEAVES if ref_grad[k] >= NEGLIGIBLE * median]
    scale = statistics.median(reference[k] for k in kept)
    return float(np.max([abs(program[k] - reference[k]) / max(reference[k], scale, 1e-30)
                         for k in kept]))


def numbers(program: dict, reference: dict) -> dict:
    """The compared numbers of `program`'s steps against `reference`'s (both
    as `steps` returns them)."""
    if len(program["losses"]) != len(reference["losses"]):
        raise ValueError("compare: the program and the reference took different steps")
    # np.max: a number that is not finite stays so, and fails its check
    loss_gap = float(np.max([abs(p - r) / max(abs(r), 1e-30)
                             for p, r in zip(program["losses"], reference["losses"])]))
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(program["first_grad"], reference["first_grad"],
                                    reference["first_grad"]),
            "change_gap": _worst_leaf(program["change"], reference["change"],
                                      reference["first_grad"])}
