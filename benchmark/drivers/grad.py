"""Traffic of inverse-rendering steps, one at a time (a closed loop): what a
user of a differentiable renderer runs.

Set-up writes two scene files of the configuration into TMPDIR
(`inputs/`): the target scene as the configuration states it, and the
start scene, whose bsdf reflectances are the target's scaled by factors
drawn from `--seed` (uniform in `reflectance_scale`, at most
`reflectance_max`), and whose emitters' radiance is scaled by a factor a
channel (uniform in `radiance_scale`, all under 1: a radiance at its
optimum would get a gradient of noise alone, which Adam turns into moves
of about its learning rate in signs the noise sets). It loads both as the CLI does (`scene/xml.load_xml`;
the host span `load`), renders the target image once
(`integrators/common.render`, `target_spp` samples, no gradient), makes
the start scene's vertices, bsdf reflectances and emitter radiances
leaves that require grad, and builds one torch.optim.Adam over them (a
learning rate a leaf, `lr`). Request k is one step:
`integrators/boundary.render_grad` with the default BoundaryConfig at
`spp` samples and the seed `--seed` + 1 + k (each step draws new
samples), the L2 loss (the mean squared gap over pixels and channels) to
the target, autograd's backward and the Adam update; the step ends when
the update is done on the card. Set-up runs the first `check_steps` steps
through that same call, and the window continues the same optimisation.

End-to-end: `grad_step_s`, the window's seconds over the whole steps it
finished. In a traced run each window step synchronises around the
backward, whose mean seconds `backward_s.grad` reads.

The check: the set-up steps' losses, the norm of each leaf's first
gradient (from Adam's first moment after step 1) and of its change over
the steps, and step 1's image, against the plain reference's steps from
the same start scene files (`reference/gradstep.py`) and its independent
images of the start scene at `spp` (`reference/compare.py`'s
worst_image_error). The vertices are not compared (the reference has no
boundary terms); their norms are reported beside the numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np

LEAVES = ("vertices", "reflectance", "radiance")


def _state_unchanged(step):
    """The optimizer's step returns with every leaf as it was."""
    def broken(self, closure=None):
        return None
    return broken


def _half_the_samples(render_grad):
    """Half of each step's samples left out, the mean taken over the rest."""
    def broken(scene, cam, cfg, bc=None):
        cfg = dataclasses.replace(cfg, spp=max(1, cfg.spp // 2))
        return render_grad(scene, cam, cfg) if bc is None else render_grad(scene, cam, cfg, bc)
    return broken


def _altered_image(render_grad):
    """An answer altered where it is produced: red and blue swapped."""
    def broken(*args, **kw):
        return render_grad(*args, **kw)[..., [2, 1, 0]]
    return broken


RENDER_GRAD = "mitsuba_tpu_torch.integrators.boundary"
FAULTS = {"state_unchanged": ("torch.optim", "Adam.step", _state_unchanged),
          "half_the_samples": (RENDER_GRAD, "render_grad", _half_the_samples),
          "altered_image": (RENDER_GRAD, "render_grad", _altered_image)}


class Driver:
    def __init__(self, cell, device, seed: int, spans: dict, tally=None):
        self.cell = cell
        self.device = device
        self.seed = seed
        self.spans = spans
        self.traffic = cell.traffic
        self.tally = tally      # harness/queries.Tally of a traced run
        self.k = 0
        self.program = None     # the set-up steps' readings

    # -- set-up --------------------------------------------------------------
    def setup(self):
        import torch

        from benchmark.inputs import scene_file
        from mitsuba_tpu_torch import cli
        from mitsuba_tpu_torch.integrators import boundary, common
        from mitsuba_tpu_torch.scene import xml

        self.torch, self.boundary = torch, boundary
        tr, cfg_file = self.traffic, self.cell.config
        self.tmp = tempfile.mkdtemp(prefix="bench-scene-")
        rng = np.random.default_rng(self.seed)
        refl = np.asarray(scene_file.reflectances(cfg_file), np.float64)
        lo, hi = tr["reflectance_scale"]
        start_refl = np.minimum(refl * rng.uniform(lo, hi, refl.shape), tr["reflectance_max"])
        lo, hi = tr["radiance_scale"]
        factor = rng.uniform(lo, hi, 3)
        self.xml = {}
        for name, r, f in (("target", None, None),
                           ("start", start_refl.astype(np.float32), factor)):
            d = f"{self.tmp}/{name}"
            os.makedirs(d)
            self.xml[name] = scene_file.write(d, cfg_file, refl=r, radiance_factor=f)
        scenes = {}
        for name in ("target", "start"):
            t0 = time.perf_counter()
            scenes[name] = xml.load_xml(self.xml[name], device=self.device)
            self.sync()
            self.spans.setdefault("load", []).append(time.perf_counter() - t0)
        scene_t, cam, cfg, integ = scenes["target"]
        if integ != "path":
            raise NotImplementedError(f"boundary.render_grad renders path, not '{integ}'")
        self.cfg = dataclasses.replace(cfg, spp=tr["spp"])
        with torch.no_grad():
            self.target = common.render(scene_t, cam, cli.resolve_integrator(integ),
                                        dataclasses.replace(cfg, spp=tr["target_spp"],
                                                            seed=self.seed % 2 ** 32))
        del scene_t
        scene, self.cam = scenes["start"][0], scenes["start"][1]
        self.leaves = {"vertices": scene.vertices, "reflectance": scene.materials.reflectance,
                       "radiance": scene.emitters.radiance}
        self.leaves = {k: v.detach().clone().requires_grad_(True)
                       for k, v in self.leaves.items()}
        self.first = {k: v.detach().clone() for k, v in self.leaves.items()}
        self.scene = scene.replace(
            vertices=self.leaves["vertices"],
            materials=scene.materials.replace(reflectance=self.leaves["reflectance"]),
            emitters=scene.emitters.replace(radiance=self.leaves["radiance"]))
        self.opt = torch.optim.Adam([{"params": [self.leaves[k]], "lr": tr["lr"][k]}
                                     for k in LEAVES], betas=tuple(tr["betas"]), eps=tr["eps"])
        self.bc = boundary.BoundaryConfig()
        if self.tally is not None:
            self.tally.n_tris = self.scene.num_triangles
        losses, image, first_grad = [], None, {}
        for k in range(tr["check_steps"]):
            rec = self.request(keep_image=k == 0)
            losses.append(rec["loss"])
            if k == 0:
                image = rec["image"]
                b1 = tr["betas"][0]
                # an optimizer that did not step has no moment: 0
                first_grad = {n: float((self.opt.state[p].get("exp_avg", torch.zeros(()))
                                        / (1 - b1)).norm()) for n, p in self.leaves.items()}
        change = {n: float((p.detach() - self.first[n]).norm()) for n, p in self.leaves.items()}
        self.program = {"losses": losses, "first_grad": first_grad, "change": change,
                        "image": image}

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    # -- one request -----------------------------------------------------------
    def request(self, traced: bool = False, keep_image: bool = False):
        span = self._span if traced else (lambda name: contextlib.nullcontext())
        timed = self.tally is not None and not traced
        k = self.k
        self.k += 1
        cfg = dataclasses.replace(self.cfg, seed=(self.seed + 1 + k) % 2 ** 32)
        rec = {}
        t0 = time.perf_counter()
        with span("bench.request"):
            with span("bench.forward"):
                img = self.boundary.render_grad(self.scene, self.cam, cfg, self.bc)
                loss = ((img - self.target) ** 2).mean()
            self.opt.zero_grad(set_to_none=True)
            if timed:
                self.sync()
                tb = time.perf_counter()
            with span("bench.backward"):
                loss.backward()
            if timed:
                self.sync()
                rec["backward_s"] = time.perf_counter() - tb
            with span("bench.update"):
                self.opt.step()
            self.sync()
        rec["latency_s"] = time.perf_counter() - t0
        rec["loss"] = float(loss.detach())
        if keep_image:
            rec["image"] = img.detach().cpu().numpy()
        return rec

    def _span(self, name):
        from torch.profiler import record_function

        return record_function(name)

    # -- the window --------------------------------------------------------------
    def counters(self) -> dict:
        return {}

    def window_counters(self, before: dict, after: dict, records: list) -> dict:
        out = {"requests": len(records)}
        bw = [r["backward_s"] for r in records if "backward_s" in r]
        if bw:
            out["backward_s"] = sum(bw) / len(bw)
        return out

    def end_to_end(self, records: list, window_s: float) -> dict:
        return {"grad_step_s": window_s / len(records)}

    # -- the check ---------------------------------------------------------------
    def sample_window(self):
        """The set-up steps are what the check reads: nothing to add."""

    def free(self):
        self.scene = self.cam = self.opt = self.leaves = self.first = self.target = None

    def readings(self, dtype=None) -> dict:
        """The compared numbers of the set-up steps against the reference's
        (`reference/gradstep.py`, `reference/compare.py`); with `dtype` the
        reference in that dtype stands in the program's place (the
        control)."""
        import torch

        from benchmark.reference import compare, gradstep, pathtracer, scene as rscene

        tr, chk = self.traffic, self.cell.check
        start, target = rscene.load(self.xml["start"]), rscene.load(self.xml["target"])
        ref = gradstep.steps(start, target, tr, self.seed * 2 + 1, self.device)
        ref_images = pathtracer.render(start, tr["spp"], chk["reference_images"],
                                       self.seed * 2 + 3, self.device)
        if dtype is None:
            program = self.program
        else:
            program = gradstep.steps(start, target, tr, self.seed * 2 + 5, self.device, dtype)
            program["image"] = pathtracer.render(start, tr["spp"], 1, self.seed * 2 + 7,
                                                 self.device, dtype)[0]
        self.reference = ref
        values = gradstep.numbers(program, ref)
        values["image_error"] = compare.numbers(program["image"][None], ref_images,
                                                chk["block"])["worst_image_error"]
        return values

    def notes(self) -> dict:
        """The program's readings that are not compared: the vertices'."""
        if self.program is None:
            return {}
        notes = {"first_grad": self.program["first_grad"], "change": self.program["change"],
                 "losses": self.program["losses"]}
        if getattr(self, "reference", None) is not None:
            notes.update({"reference_" + k: v for k, v in self.reference.items()})
        return notes

    def cleanup(self):
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self):
        """(correct, checks) of the set-up steps against the reference."""
        from benchmark.reference import compare

        try:
            return compare.judge(self.readings(), self.cell.check["limits"])
        finally:
            self.cleanup()
