"""Film checkpoint/resume + progressive rendering with a timelog (port of
utils/checkpoint.py; the `.npz` format is the JAX package's).

The reference has no true resume — SIGHUP flushes the film, `-r sec` spawns
a periodic flush thread (src/mitsuba/mitsuba.cpp:91-127), and the fork's
CPPM writes per-pass snapshots + `<prefix>_timelog.txt`
(src/integrators/cppm/cppm_framework.h:104,219-266). Here rendering is a
pure function of (scene, pass index), so checkpointing IS resume: persist
the accumulated film + sample counter + config hash, reload, continue at
the exact next sample index. The counter-based sampler (core/rng.py) makes
the resumed render equal to an uninterrupted one up to the float32 sum
order of the passes.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class RenderState:
    """Accumulated film sum + how many spp are already in it."""

    image_sum: np.ndarray     # (H, W, 3) sum over completed samples
    spp_done: int
    cfg_key: str              # guards against resuming with a changed config
    wall_time: float = 0.0    # accumulated render seconds

    @property
    def image(self) -> np.ndarray:
        return self.image_sum / max(self.spp_done, 1)

    def save(self, path):
        np.savez(
            Path(path),
            image_sum=self.image_sum,
            meta=json.dumps({
                "spp_done": self.spp_done,
                "cfg_key": self.cfg_key,
                "wall_time": self.wall_time,
            }),
        )

    @staticmethod
    def load(path) -> "RenderState":
        with np.load(Path(path), allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            return RenderState(
                image_sum=z["image_sum"],
                spp_done=int(meta["spp_done"]),
                cfg_key=str(meta["cfg_key"]),
                wall_time=float(meta.get("wall_time", 0.0)),
            )


def cfg_key(cfg, cam) -> str:
    return json.dumps(
        {**dataclasses.asdict(cfg), "w": cam.width, "h": cam.height},
        sort_keys=True,
    )


def render_progressive(
    scene, cam, li_fn, cfg, total_spp: int, pass_spp: int = 16,
    checkpoint_path=None, timelog_path=None, snapshot_every: int = 0,
    snapshot_prefix: str = "snapshot", progress: bool = False,
    on_pass=None,
):
    """Accumulate `total_spp` in passes of `pass_spp` through
    common.render_jit(..., sample_offset=spp_done) (one capture on the
    card serves every full pass), checkpointing after each
    pass and appending cumulative seconds to the timelog (the fork's
    convergence-experiment protocol, cppm_framework.h:219-266: one
    cumulative time per line per pass). `on_pass(state)` runs after each
    pass (the CLI's flush hook).

    Resumes from checkpoint_path if it exists and matches the config.
    Returns the final RenderState.
    """
    from ..integrators import common
    from .stats import ProgressReporter

    key = cfg_key(cfg, cam)
    state = None
    if checkpoint_path and Path(str(checkpoint_path)).exists():
        state = RenderState.load(checkpoint_path)
        if state.cfg_key != key:
            state = None  # config changed: restart
    if state is None:
        state = RenderState(
            image_sum=np.zeros((cam.height, cam.width, 3), np.float32),
            spp_done=0,
            cfg_key=key,
        )

    reporter = ProgressReporter("Rendering", total_spp, enabled=progress)
    reporter.update(state.spp_done)
    while state.spp_done < total_spp:
        n = min(pass_spp, total_spp - state.spp_done)
        # pass samples are [spp_done, spp_done + n) of the SAME global
        # sample set
        pass_cfg = dataclasses.replace(cfg, spp=n, spp_chunk=n)
        t0 = time.time()
        img = common.render_jit(scene, cam, li_fn, pass_cfg,
                                sample_offset=state.spp_done).cpu().numpy()
        state.wall_time += time.time() - t0
        state.image_sum = state.image_sum + img * n
        state.spp_done += n

        reporter.update(state.spp_done)
        if checkpoint_path:
            state.save(checkpoint_path)
        if timelog_path:
            with open(timelog_path, "a") as f:
                f.write(f"{state.wall_time:.3f}\n")
        if snapshot_every and (state.spp_done // pass_spp) % snapshot_every == 0:
            from ..io import image as imagelib

            imagelib.write_image(
                f"{snapshot_prefix}_{state.spp_done:05d}spp.exr", state.image
            )
        if on_pass is not None:
            on_pass(state)
    reporter.finish()
    return state
