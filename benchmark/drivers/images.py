"""Traffic of whole images, one at a time (a closed loop): the CLI's default
route for an integrator with a per-ray Li (`cli._render_rank`).

Set-up writes the configuration's scene file into TMPDIR (`inputs/`),
loads it as the CLI does (`scene/xml.load_xml`, then `scene/bvh.attach`
above `ops/trace.BRUTE_MAX_TRIS` triangles; the host span `load`), takes
the configuration's seed from `--seed` (mod 2^32, the program's hash
width) and renders `warmup_images` images, which capture the render's
graph and replay it once. Request k then renders image k through
`integrators/common.render_jit` with sample_offset = k * spp (one capture
serves the window) and copies it to host memory, as the CLI does before
writing it. A request's latency runs from the call to the image on the
host.

End-to-end: `samples_per_s` (every pixel sample of the window's images
over the window's seconds) and `image_p90_s` (the 90th percentile of the
images' latencies). Counters over the window: the graphs replayed and
captured (`utils/graphs.STATS`); a capture inside the window is an error.

The check keeps a sample of `checked_images` of the window's images,
drawn from the seed (reservoir sampling), and compares them with
`reference_images` images of the plain reference (`reference/`), which
reads the same scene file (`reference/compare.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import shutil
import tempfile
import time

import numpy as np


# faults planted in the timed path, `common.render_jit` (harness/faults.py)
def _state_unchanged(render):
    """The film's accumulators come back as they started."""
    def broken(scene, cam, li, cfg, sample_offset=0):
        import torch

        return torch.zeros((cam.height, cam.width, 3), device=scene.device)
    return broken


def _half_the_samples(render):
    """Half of each image's samples left out, the mean taken over the rest."""
    def broken(scene, cam, li, cfg, sample_offset=0):
        return render(scene, cam, li, dataclasses.replace(cfg, spp=cfg.spp // 2),
                      sample_offset=sample_offset)
    return broken


def _altered_image(render):
    """An answer altered where it is produced: red and blue swapped."""
    def broken(scene, cam, li, cfg, sample_offset=0):
        return render(scene, cam, li, cfg, sample_offset=sample_offset)[..., [2, 1, 0]]
    return broken


RENDER_JIT = "mitsuba_tpu_torch.integrators.common"
FAULTS = {"state_unchanged": (RENDER_JIT, "render_jit", _state_unchanged),
          "half_the_samples": (RENDER_JIT, "render_jit", _half_the_samples),
          "altered_image": (RENDER_JIT, "render_jit", _altered_image)}


class Driver:
    def __init__(self, cell, device, seed: int, spans: dict, tally=None):
        self.cell = cell
        self.device = device
        self.seed = seed
        self.spans = spans
        self.traffic = cell.traffic
        self.k = 0
        self.kept = []          # (k, image) of the reservoir
        self.seen = 0
        self.pick = random.Random(seed)
        self.tally = tally      # harness/queries.Tally of a traced run

    # -- set-up --------------------------------------------------------------
    def setup(self):
        import torch

        from benchmark.inputs import scene_file
        from mitsuba_tpu_torch import cli
        from mitsuba_tpu_torch.integrators import common
        from mitsuba_tpu_torch.ops import trace
        from mitsuba_tpu_torch.scene import bvh, xml
        from mitsuba_tpu_torch.utils import graphs

        self.torch, self.common, self.graphs = torch, common, graphs
        self.tmp = tempfile.mkdtemp(prefix="bench-scene-")
        self.xml_path = scene_file.write(self.tmp, self.cell.config)
        t0 = time.perf_counter()
        scene, cam, cfg, integ = xml.load_xml(self.xml_path, device=self.device)
        if scene.num_triangles > trace.BRUTE_MAX_TRIS and scene.bvh is None:
            scene = bvh.attach(scene)
        self.sync()
        self.spans.setdefault("load", []).append(time.perf_counter() - t0)
        self.scene, self.cam = scene, cam
        self.cfg = dataclasses.replace(cfg, seed=self.seed % 2 ** 32)
        self.li = cli.resolve_integrator(integ)
        self.samples = cam.width * cam.height * self.cfg.spp
        if self.tally is not None:
            self.tally.n_tris = scene.num_triangles
        for _ in range(self.traffic["warmup_images"]):
            self.request(keep=False)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    # -- one request -----------------------------------------------------------
    def request(self, traced: bool = False, keep: bool = True):
        span = self._span if traced else (lambda name: contextlib.nullcontext())
        k = self.k
        self.k += 1
        t0 = time.perf_counter()
        with span("bench.request"):
            with span("bench.render"):
                img = self.common.render_jit(self.scene, self.cam, self.li, self.cfg,
                                             sample_offset=k * self.cfg.spp)
            with span("bench.to_host"):
                img = img.cpu()
        latency = time.perf_counter() - t0
        if keep:
            self._keep(k, img.numpy())
        return {"latency_s": latency, "samples": self.samples}

    def _span(self, name):
        from torch.profiler import record_function

        return record_function(name)

    def _keep(self, k, img):
        n = self.cell.check["checked_images"]
        self.seen += 1
        if len(self.kept) < n:
            self.kept.append((k, img))
        else:
            j = self.pick.randrange(self.seen)
            if j < n:
                self.kept[j] = (k, img)

    # -- the window --------------------------------------------------------------
    def counters(self) -> dict:
        return dict(self.graphs.STATS)

    def window_counters(self, before: dict, after: dict, records: list) -> dict:
        if after["captures"] != before["captures"]:
            raise RuntimeError(f"{after['captures'] - before['captures']} CUDA graph "
                               "capture(s) inside the measured window")
        return {"requests": len(records), "replays": after["replays"] - before["replays"]}

    def end_to_end(self, records: list, window_s: float) -> dict:
        lat = [r["latency_s"] for r in records]
        p90 = float(np.quantile(lat, 0.9, method="linear")) if lat else float("nan")
        return {"samples_per_s": sum(r["samples"] for r in records) / window_s,
                "image_p90_s": p90}

    # -- the check ---------------------------------------------------------------
    def sample_window(self):
        """Render the images that a window of the check's `window_images`
        would keep: a draw from the seed of image numbers, as the
        reservoir's."""
        n = self.cell.check["checked_images"]
        first = self.traffic["warmup_images"]
        window = self.cell.check["window_images"]
        ks = sorted(random.Random(self.seed).sample(range(first, first + window), n))
        self.kept = []
        for k in ks:
            img = self.common.render_jit(self.scene, self.cam, self.li, self.cfg,
                                         sample_offset=k * self.cfg.spp)
            self.kept.append((k, img.cpu().numpy()))

    def free(self):
        self.scene = self.cam = None

    def readings(self, dtype=None) -> dict:
        """The compared numbers of the kept images against the reference
        (`reference/compare.py`); with `dtype` the reference in that dtype
        stands in the program's place (the control)."""
        import torch

        from benchmark.reference import compare, pathtracer, scene as rscene

        chk = self.cell.check
        ref_scene = rscene.load(self.xml_path)
        if dtype is None:
            program = np.stack([img for _, img in sorted(self.kept, key=lambda x: x[0])])
        else:
            program = pathtracer.render(ref_scene, ref_scene.spp, len(self.kept),
                                        self.seed * 2 + 2, self.device, dtype)
        ref = pathtracer.render(ref_scene, ref_scene.spp, chk["reference_images"],
                                self.seed * 2 + 1, self.device, torch.float32)
        return compare.numbers(program, ref, chk["block"])

    def check(self):
        """(correct, checks) of the kept images against the reference."""
        from benchmark.reference import compare

        try:
            return compare.judge(self.readings(), self.cell.check["limits"])
        finally:
            self.cleanup()

    def notes(self) -> dict:
        return {}

    def cleanup(self):
        shutil.rmtree(self.tmp, ignore_errors=True)
