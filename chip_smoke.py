#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mitsuba_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the repository's sources (one nvcc each, in
parallel), checks each kernel against its plain PyTorch version on the card
(bit for bit) and times both, renders the golden configuration, the
headline Cornell render (256x256, 256 spp, depth 8) and the big-mesh render
(the 70,034-triangle displaced sphere, 128x128, 16 spp, depth 4, fused and
compacted wavefront) through the kernels, and checks the images. Then the
gradient path, both kernels inside reverse-mode steps: the gradients
through each kernel against those through its plain twin, the quad-blocker
shadow gradient and the 10,372-triangle mesh-scale gradient against finite
differences, an inverse recovery on the mesh, and the headline gradient
(Cornell 256x256, 8 spp, an L2 loss through boundary.render_grad) timed,
with its peak memory and device busy share; in the mesh and headline
steps, one launch of each kernel entry at each batch size the step takes
is rerun through the plain twin, bit for bit. Then the materials and
lighting slice, all through the brute-force kernel: the veach_mis and
envmap_textured goldens and both caustic_box mirrors; the Veach MIS sweep
at 256x192, 64 spp, depth 3, through the wavefront (timed, useful rays/s,
busy share) and a small render through the wavefront and path.li, equal
within 1e-5; the textured quad at 256x256, 64 spp, with a 1,024x1,024
mipped texture (trilinear and EWA lookups) under a 512x1,024 environment
map, and the map's total radiance by importance sampling; the roughness
and texel gradients against finite differences. In each of these, too,
one launch per kernel entry and batch size is rerun through the twin.
Then participating media and delta lights, through volpath.li: the
volpath_homogeneous golden; the golden's fog in the Cornell box at
256x256, 64 spp, depth 6 (darker than the vacuum render); an absorbing blob
on a 128^3 density grid at 256x256, 8 spp (each blob position darkens its
own half; the share of device time in the density lookups); a spot light's
beam in the fog, a point light through the wavefront (and the wavefront
against path.li); the 10,372-triangle sphere_shadow in the fog on the BVH
kernel; the sigma_t and albedo gradients against finite differences. Each
counts its kernel's launches from zero and reruns one launch per entry and
batch size through the twin.
Then the render front end: the Cornell box at 256x256, 64 spp, depth 8, as
a user's scene names it (the LD sampler, the Gaussian filter, a thin lens)
against the box, pinhole, independent render; every sampler kind on the
card against the CPU, its time per dimension, and LD against independent;
every filter's render and its splat on the card against the CPU; every
sensor kind and a motion-blurred pinhole, the meters' closed forms, motion
blur's smear and the thin-lens wavefront against path.li; the
70,034-triangle sphere at 1,024x1,024 through the tiled film, read back
from its EXR, against the full frame; a Cornell box with vertex colours
and a wireframe material.
Then the user's entry point, `python -m mitsuba_tpu_torch scene.xml -o
out.exr`, on scene files written from the fixtures (one OBJ per material
run): the front end's Cornell configuration (B1), the 70,034-triangle mesh
at 128x128 (B2, the CLI attaches the BVH) and at 1,024x1,024 through the
tiled film (`-D film=tiledhdrfilm`); each by the real command as a
subprocess and by cli.main in process with its launches counted and twin
checked, the loaded arrays equal to the fixture's, the images equal to the
in-process renders of the builtin scenes.
Then the bidirectional family (the [bidir] group, BIDIR_PHASES): bdpt.li
and bdpt.render (the light image) on the Cornell box at 256x256 x 16 spp,
depth 8, and the light image on caustic_box; lvcbpt.li in its three MIS
modes and on a point light; ptracer.render (1,048,576 particles); vpl.li;
path.li and lvcbpt.li with the occupancy map's shadows, and the march
against B1's any-hit at 2^19 lanes; the depth, normal, ao and motion
AOVs and multichannel.render; bdpt and lvcbpt on the 10,372-triangle mesh
through B2; the CLI's lvcbpt and ptracer on [cli_cornell]'s scene files.
Each mean is held to its JAX test's bar against path.li's render of the
same scene, each cell counts its kernel's launches from zero and reruns
one launch per entry and batch size through the twin.
Then the photon-mapping family (the [photon] group, PHOTON_PHASES), each
cell counted and twin checked the same way: sppm.render on the Cornell box
at 256x256 (16 passes x 2^17 photons, depth 8) with its seconds a pass and
a pass's camera, photon, build and query shares, the CPPM constant and
linear radius strategies (r2 after each pass), the two-map photon mapper
and caustic_box's caustic and indirect deposits, bre in the fog against
volpath.li, the irradiance cache against path.li and direct.li, spectral.li
on the gray box per channel, render_adaptive's spp map, SPPM on the
10,372-triangle mesh through B2, and the CLI's sppm and spectral on
[cli_cornell]'s scene files.
Then daylight, woven cloth and primary-sample Metropolis (the [daylight]
group, DAYLIGHT_PHASES), counted and twin checked the same way: a scene
file under tests/test_sunsky.py's sunsky (the 512x256 baked map and its
11-band stack) through the wavefront at 256x256 x 64 spp, depth 8, against
common.render, and through spectral.li; the big mesh under the same sky on
B2; tests/test_irawan.py's quad in cotton and silk at 256x256 x 64 spp,
and 2^20 cloth lanes on the card against the CPU; pssmlt and erpt on the
Cornell box at 256x256, depth 8, 2^15 chains x 64 mutations from 2^17
bootstrap paths, against path.li's mean; the real command on a sunsky
and cloth scene file, and the CLI's pssmlt and erpt.
Then path-space Metropolis and the tools (the [mlt] group, MLT_PHASES),
counted and twin checked the same way: the manifold walk on 2^18 lanes of
tests/test_manifold.py's flat mirror against the closed form, and 4,096
lanes on the card against the CPU; mlt.render on the Cornell box at
256x256, depth 8 (the JAX defaults: 2^14 chains from 2^16 bootstrap
paths; 64 mutations, five kernels), on caustic_box with a perfect mirror
(depth 4, 24 mutations, six kernels: the manifold perturbation walks)
and on tests/test_mlt_manifold.py's glass-sphere box (128x128, depth 5),
each mean within its JAX test's bar of path.li's and every kernel's
acceptance above 0; the CLI's mlt on [cli_cornell]'s files and its
pssmlt route on a sunsky file; `mtsutil kdbench` on the Cornell box (B1)
and the 70,034-triangle OBJ pair (B2); `mtsutil mtsimport` of a .dae
written here, loaded and rendered.
Then sharded and multi-process rendering, the dipole, the chi-square
harness and the native binding (the [parallel] group, PARALLEL_PHASES):
render_sharded on a one-rank NCCL group in process at mesh (1, 1), the
Cornell box at 256x256 x 16 spp, depth 8, with the box and the Gaussian
film, and the 70,034-triangle sphere on B2, each equal to common.render's
image; three train_step calls at 256x256 x 4 spp, the loss falling; two
processes of the real command with --distributed sharing the card (gloo)
and --mesh 1,1 (NCCL) in process, its B1 launches counted and twin
checked, each image equal to the one-process CLI image; the dipole on the Cornell box's short block (4,096 cache points,
the gather at the 65,536 first hits, single scattering with exact NEE),
the slab fixture's exact/classical ratio, and 1,024 queries on the card
against the CPU; spherical_chi2 at 2^20 samples for the eight new warps
and tests/test_bsdf.py's BSDF records; the native OBJ parse and BVH build
of the 70,034-triangle pair against the Python ones, both timed.
Then the compiled renders (the [jit] group, JIT_PHASES): [cli_cornell]'s
configuration through common.render_jit (CUDA graphs: the first chunk
eager, the chunk captured, every later one replayed) with the Gaussian
and the box film, the progressive renderer over four passes (one
capture), the 70,034-triangle sphere through B2 inside the graph, and the
headline and the big mesh through wavefront.render_jit (a step graph per
lane width), each against the eager render of this run, its launches
counted per replay and equal to the eager ones, with both busy shares.
Then the film renderers' compiled renders (the [jit_film] group,
JIT_FILM_PHASES): ptracer, bdpt's light image, bre, pssmlt, erpt, mlt
(five kernels, and six with kernel F's walks in their graph-safe form),
irrcache's film and the sharded render (box film and the 70,034-triangle
sphere through B2) through their render_jit, each against the eager
render of the same configuration in this run (the earlier groups' cells,
EAGER_CELLS; MLT with F against its own fixed-walk eager render): the
eager, first and replayed seconds, the captures and replays, both busy
shares, the replayed launches equal to the eager ones.
Every phase prints one line; any failure raises, so the exit code is
non-zero. The line [total] gives the whole script's seconds and those of
the materials, the media, the front-end, the CLI, the bidirectional, the
photon, the daylight, the mlt, the parallel, the jit and the jit_film
phases.
The line before the last lists the kernels as JSON; the last names the
device. Needs a CUDA device: without one it exits non-zero and prints no
result.

Times in the kernels' JSON line: `ms` is the kernel's own device time per
launch (torch.profiler's records of the kernel's symbol, `device_ms`);
`call_ms` is one wrapper call timed by CUDA events (`call_ms`), the host's
checks, allocations and ctypes launch included, so where the kernel is
shorter than the host's work it times the host; `plain_ms` is the plain
PyTorch version's call. `launches` is the count from the kernel's path.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

# Headline render: the JAX package's mean radiance of this configuration on
# a TPU (BENCH_r05.json). Its camera matmul ran at the TPU's default
# precision, which rounds both operands to bfloat16, and that alone moves the
# mean by ~1.4% (float32 gives ~0.2569). The check therefore renders the
# same samples once more with that rounding emulated (in the camera rotation
# only) and holds that mean to 1% of the TPU's. The timed float32 render is
# held to be finite and within 2% of it: the 1.4% the rounding explains, plus
# margin.
HEADLINE_MEAN = 0.253395
HEADLINE_MEAN_RTOL = 0.01
HEADLINE_F32_MEAN_RTOL = 0.02
# golden bar of tests/test_torch_render.py (cornell_path) and
# tests/test_torch_grad.py (cornell_direct): rtol = atol = 1e-4 except at
# most GOLDEN_MAX_FLIPS pixels, each within GOLDEN_MAX_FLIP (one sample of
# 64 that took another path at a geometric edge)
GOLDEN_TOL = 1e-4
GOLDEN_MAX_FLIPS = 1
GOLDEN_MAX_FLIP = 0.01
KERNEL_RAYS = 1 << 18
# Big-mesh render: the JAX package's bigmesh_70k_render_mean on a TPU
# (BENCH_r05.json), whose camera ran at the TPU's bfloat16 matmul precision
# (see HEADLINE_MEAN); held to 1% with that rounding emulated.
BIGMESH_MEAN = 0.016075248
BIGMESH_MEAN_RTOL = 0.01
# kernel against brute force on the big mesh: tests/test_bvh.py:163-169
BVH_AGREE = 0.998
BVH_T_RTOL, BVH_T_ATOL = 1e-4, 1e-5
# (source, TPU kernel replaced, the path whose run counts its launches, the
# CUDA symbol the device timer reads): the Cornell headline render; the
# big-mesh render (wavefront, fused and compacted: the fused entry only);
# the big-mesh useful-ray count pass (path.li_with_stats, unfused: the
# closest and any-hit entries)
KERNELS = {
    "brute_closest": ("mitsuba_tpu_torch/csrc/brute_intersect.cu",
                      "mitsuba_tpu/ops/pallas_intersect.py:41", "headline_render",
                      "closest_kernel"),
    "brute_any_hit": ("mitsuba_tpu_torch/csrc/brute_intersect.cu",
                      "mitsuba_tpu/ops/pallas_intersect.py:41", "headline_render",
                      "any_hit_kernel"),
    "bvh_closest": ("mitsuba_tpu_torch/csrc/bvh_intersect.cu",
                    "mitsuba_tpu/ops/binned_intersect.py:358", "bigmesh_count_pass",
                    "walk_kernel"),
    "bvh_any_hit": ("mitsuba_tpu_torch/csrc/bvh_intersect.cu",
                    "mitsuba_tpu/ops/binned_intersect.py:358", "bigmesh_count_pass",
                    "walk_kernel"),
    "bvh_closest_and_any": ("mitsuba_tpu_torch/csrc/bvh_intersect.cu",
                            "mitsuba_tpu/ops/binned_intersect.py:358", "bigmesh_render",
                            "walk_kernel"),
}
# Bounds: the H100 SXM's published peaks (HBM3; float32 outside the tensor
# cores, 67 TFLOP/s counting an FMA as two operations, so 33.5e12 float32
# instructions per second), and the float32 instructions each test needs at
# the least, every multiply-add pair contracted into one FMA (add, sub, mul,
# FMA, div, min, max; compares not counted). The kernels, built with
# --fmad=false, issue more: 46 and 22 separate operations.
# Moller-Trumbore 32: two cross products 12 (mul + FMA per component),
# three dot products 9 (mul + 2 FMA), three scalings, the division, three
# subtractions and u + v. Slab test 16: 6 FMA (lo * inv - o * inv, the
# product o * inv once per ray), 6 per-axis min/max, 4 for entry and exit.
PEAK_F32_INSTR = 33.5e12
PEAK_HBM_BYTES = 3.35e12
TRI_INSTR = 32
SLAB_INSTR = 16
RAY_BYTES = 28    # o, d, tmax (float32)


# the eager images of [headline] and [bigmesh] ((image, config, launches)),
# which [jit_wavefront] holds its replayed renders against
EAGER_IMAGES = {}
# every bidir_cell's (image, config, launches, render seconds), which the
# [jit_film] group holds its replayed renders against
EAGER_CELLS = {}
# every profile_call's busy share, by its render's name
PROFILE_BUSY = {}


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warnings only where an op has
    none; uninitialised memory left unfilled), under which `index_add_`
    sums in a fixed order: the Metropolis cells render under it, eager and
    replayed, so that a replay's image equals the eager one bit for bit
    (their chains are a function of the seed in either mode, ROADMAP
    C48)."""
    import torch
    import torch.utils.deterministic

    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def call_ms(fn, dev, reps=10):
    """Mean milliseconds of one call of fn() (CUDA events around reps calls,
    after a warm-up): the wrapper's host work and the device's together.
    Where the host is slower than the kernel, this times the host."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def device_ms(fn, symbol, dev, reps=20):
    """Mean device milliseconds of one launch of the kernel whose symbol
    contains `symbol`: torch.profiler's CUDA kernel records of reps calls
    of fn() (after a warm-up), their summed device time over their count.
    The profiler may drop a record at the edge of its window (seen: 19 of
    20) or, rarely, a whole window (seen: 0 of 50), so the mean is over the
    records it kept, and a window that kept fewer than half is taken again,
    up to three times; then, or with more than one record per call, it
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
        mine = [e for e in prof.key_averages()
                if e.device_type == cuda and symbol in e.key]
        count = sum(e.count for e in mine)
        if reps // 2 <= count <= reps:
            return sum(e.device_time_total for e in mine) / 1e3 / count
        if count > reps:
            break
    raise AssertionError(f"profiler saw {count} launches of {symbol!r} in {reps} "
                         f"calls: {[e.key for e in mine]}")


def random_scene(n_tris, seed, dev):
    from mitsuba_tpu_torch.scene import ir

    rs = np.random.RandomState(seed)
    base = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], 0)
    tris = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    return ir.build_scene(verts, tris, np.zeros(n_tris, np.int32),
                          [{"type": ir.BSDF_DIFFUSE}], device=dev)


def shadow_scene(dev):
    """tests/test_vertex_grad.py's quad-blocker fixture, built with the
    port's build_scene (the script runs without JAX): a floor, a quad blocker
    above the camera and a small area light, so the image sees the
    blocker's shadow and not the blocker. Returns (scene, camera); the
    blocker's vertex rows are BLOCKER_ROWS."""
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.scene import ir

    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat, rad=None):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([b, b + 1, b + 2], [b, b + 2, b + 3]):
            if rad is not None:
                tri_rad[len(tris)] = rad
            tris.append(t)
            tri_mat.append(mat)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.2, 0.2, 0.2]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    add_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], 0)
    add_quad([-0.5, 0.9, -0.3], [-0.5, 0.9, 0.3], [-0.1, 0.9, 0.3], [-0.1, 0.9, -0.3], 1)
    add_quad([-0.1, 1.5, -0.1], [0.1, 1.5, -0.1], [0.1, 1.5, 0.1], [-0.1, 1.5, 0.1], 2,
             rad=[30.0, 30.0, 30.0])
    scene = ir.build_scene(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                           np.asarray(tri_mat, np.int32), [white, dark, lm],
                           tri_radiance=tri_rad, device=dev)
    cam = sensor.make_camera(origin=[-0.15, 0.8, 0.0], target=[-0.15, 0.0, 0.0],
                             up=[0, 0, 1], fov_x=45.0, width=24, height=24, device=dev)
    return scene, cam


BLOCKER_ROWS = (4, 8)


def kernel_rays(scene, n, seed, dev):
    """Rays from inside the scene's bounds: half aimed at a random point of
    a random triangle, half in random directions; any-hit limits span the
    scene."""
    import torch

    rs = np.random.RandomState(seed)
    v = scene.vertices.cpu().numpy()
    tri = v[scene.indices.cpu().numpy()]
    lo, hi = v.min(0), v.max(0)
    o = rs.uniform(lo, hi, (n, 3))
    b = rs.dirichlet((1.0, 1.0, 1.0), n)
    target = np.einsum("nk,nkc->nc", b, tri[rs.randint(0, len(tri), n)])
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o, rs.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    limit = rs.uniform(0.1, 1.0, n) * np.linalg.norm(hi - lo)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    return f32(o), f32(d), f32(limit)


def compare_kernels(name, scene, o, d, limit, plain_reps, kernel_reps):
    """Run both kernels and their plain versions once on the same rays, raise
    unless (key, chunk_base) and blocked are equal bit for bit, and time
    each. Returns the measured errors and times."""
    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import intersect

    dev = o.device
    n = o.shape[0]
    tris = intersect.tri_soa(scene)
    tmax = torch.full((n,), 3.0e38, device=dev)
    key, base = bk.closest_key(tris, o, d, tmax)
    pkey, pbase = bk.closest_key_plain(tris, o, d, tmax)
    blocked = bk.any_hit(tris, scene.tri_opaque, o, d, limit)
    pblocked = bk.any_hit_plain(tris, scene.tri_opaque, o, d, limit)
    torch.cuda.synchronize(dev)
    bad_key = int(((key != pkey) | (base != pbase)).sum())
    bad_blocked = int((blocked != pblocked).sum())
    t_k = intersect._finish_closest(scene, key, base, n).t
    t_p = intersect._finish_closest(scene, pkey, pbase, n).t
    hit = t_p < 1e30
    t_err = float((t_k - t_p)[hit].abs().max()) if bool(hit.any()) else 0.0
    blocked_err = float((blocked.int() - pblocked.int()).abs().max())
    def closest():
        return bk.closest_key(tris, o, d, tmax)

    def any_hit():
        return bk.any_hit(tris, scene.tri_opaque, o, d, limit)

    times = {
        "closest_ms": device_ms(closest, KERNELS["brute_closest"][3], dev, kernel_reps),
        "closest_call_ms": call_ms(closest, dev, kernel_reps),
        "closest_plain_ms": call_ms(
            lambda: bk.closest_key_plain(tris, o, d, tmax), dev, plain_reps),
        "any_hit_ms": device_ms(any_hit, KERNELS["brute_any_hit"][3], dev, kernel_reps),
        "any_hit_call_ms": call_ms(any_hit, dev, kernel_reps),
        "any_hit_plain_ms": call_ms(
            lambda: bk.any_hit_plain(tris, scene.tri_opaque, o, d, limit), dev, plain_reps),
    }
    say("kernel", scene=name, tris=scene.num_triangles, rays=n,
        hit_frac=round(float(hit.float().mean()), 4),
        blocked_frac=round(float(pblocked.float().mean()), 4),
        key_mismatch=bad_key, blocked_mismatch=bad_blocked, t_max_abs_err=t_err,
        **{k: round(v, 5) for k, v in times.items()}, config=dict(bk.LAST_CONFIG))
    if bad_key or bad_blocked:
        raise AssertionError(f"kernel and plain version differ on {name}: "
                             f"{bad_key} keys, {bad_blocked} blocked flags")
    return t_err, blocked_err, times


def bound(n_bytes, instr):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 instructions over the card's issue rate."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES, instr / PEAK_F32_INSTR
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def brute_bounds(scene, o, d, limit):
    """Bounds of the two brute-force entries on these rays: every ray
    tests every triangle (closest), or the triangles up to its first
    opaque hit in index order (any-hit; the kernel's early exit)."""
    import torch

    from mitsuba_tpu_torch.ops import intersect

    n, n_tris = o.shape[0], scene.num_triangles
    tris = intersect.tri_soa(scene)
    oc, dc = intersect._ray_comps(o, d)
    t = intersect._chunk_hits(oc, dc, tris, limit[:, None], limit[:, None])
    hits = (t < intersect.MISS) & scene.tri_opaque[None, :]
    first = torch.where(hits.any(1), hits.int().argmax(1) + 1, n_tris)
    tables = n_tris * (36 + 1)
    closest = bound(n * (RAY_BYTES + 8) + tables, n * n_tris * TRI_INSTR)
    any_hit = bound(n * (RAY_BYTES + 1) + tables, int(first.sum()) * TRI_INSTR)
    return closest, any_hit


def phase_kernels(dev, n_rays, headline_rays):
    """Kernel against plain version on the card at 32, 1,156 and 4,096
    triangles, and at the main path's shape (the headline's Cornell batch):
    (key, chunk_base) and blocked must agree bit for bit."""
    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import intersect
    from mitsuba_tpu_torch.scene import builtin

    cornell = builtin.cornell_box(device=dev)[0]
    cases = [("cornell", cornell, n_rays),
             ("sphere_shadow_24", builtin.sphere_shadow(24, 24, device=dev)[0], n_rays),
             ("random_4096", random_scene(4096, 4096, dev), n_rays),
             ("cornell_main_path_shape", cornell, headline_rays)]
    report = {"brute_closest": {"max_abs_err": 0.0}, "brute_any_hit": {"max_abs_err": 0.0}}
    for name, scene, n in cases:
        main_shape = name == "cornell_main_path_shape"
        o, d, limit = kernel_rays(scene, n, n + scene.num_triangles, dev)
        t_err, blocked_err, times = compare_kernels(
            name, scene, o, d, limit, plain_reps=50 if main_shape else 3,
            kernel_reps=50 if main_shape else 10)
        closest, any_hit = report["brute_closest"], report["brute_any_hit"]
        closest["max_abs_err"] = max(closest["max_abs_err"], t_err)
        any_hit["max_abs_err"] = max(any_hit["max_abs_err"], blocked_err)
        if main_shape:
            # the JSON line's times are those at the main path's shape
            (c_ms, c_by), (a_ms, a_by) = brute_bounds(scene, o, d, limit)
            for entry, k, b_ms, b_by in ((closest, "closest", c_ms, c_by),
                                         (any_hit, "any_hit", a_ms, a_by)):
                entry.update(ms=times[f"{k}_ms"], call_ms=times[f"{k}_call_ms"],
                             plain_ms=times[f"{k}_plain_ms"], bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
            # the launch's fixed cost: the same kernels on one warp of rays
            tris = intersect.tri_soa(scene)
            o1, d1, l1 = o[:32].contiguous(), d[:32].contiguous(), limit[:32].contiguous()
            floor = {
                "closest_floor_ms": device_ms(
                    lambda: bk.closest_key(tris, o1, d1, l1), KERNELS["brute_closest"][3], dev),
                "any_hit_floor_ms": device_ms(
                    lambda: bk.any_hit(tris, scene.tri_opaque, o1, d1, l1),
                    KERNELS["brute_any_hit"][3], dev)}
            closest, any_hit = report["brute_closest"], report["brute_any_hit"]
            closest["floor_ms"], any_hit["floor_ms"] = floor.values()
            # every lane count at this shape, against the launcher's choice
            tmax = torch.full((n,), 3.0e38, device=dev)
            sweep = {f"{entry}_lanes_ms": {
                lanes: round(device_ms(fn(lanes), KERNELS[f"brute_{entry}"][3], dev), 5)
                for lanes in bk.LANES} for entry, fn in (
                    ("closest", lambda ln: lambda: bk.closest_key(tris, o, d, tmax, lanes=ln)),
                    ("any_hit", lambda ln: lambda: bk.any_hit(tris, scene.tri_opaque, o, d,
                                                             limit, lanes=ln)))}
            say("kernel_bound", scene=name, rays=n, closest_bound_ms=c_ms,
                closest_bound_by=c_by, any_hit_bound_ms=a_ms, any_hit_bound_by=a_by,
                **{k: round(v, 5) for k, v in floor.items()}, **sweep)
    return report


def phase_gather_kernel(dev):
    """The gather backward's kernel pair (ops/gather.py,
    csrc/gather_backward.cu) at the grad step's shapes: 2^18 and 2^21
    lanes of 3 channels into tables of 1, 4 and 64 rows (int64 indices;
    int32 too at 2^21 x 4): the gradient against a float64
    index_put_(accumulate=True) (max_rel_err: the largest gap over the
    row's sum of |terms|), two launches bit-equal, the pair's device ms
    (both passes, torch.profiler) beside its byte bound (each lane's
    gradient and index read once), one wrapper call (CUDA events), the
    plain twin's call (PyTorch's index_put_(accumulate=True), the backward
    of table[idx]) and index_add_ (atomics) as the library's other route,
    and the pair's floor on one warp of lanes. Returns the entry's report
    at 2^21 lanes x 4 rows."""
    import torch

    from mitsuba_tpu_torch.ops import gather

    report = {}
    cases = [(n, rows, torch.int64) for n in (1 << 18, 1 << 21) for rows in (1, 4, 64)]
    cases.append((1 << 21, 4, torch.int32))
    for n, rows, dtype in cases:
        gen = torch.Generator(device=dev).manual_seed(n + rows)
        g = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
        idx = torch.randint(0, rows, (n,), generator=gen, device=dev).to(dtype)
        shape = torch.Size((rows, 3))
        ref = torch.zeros(shape, dtype=torch.float64, device=dev).index_put_(
            (idx,), g.double(), accumulate=True)
        scale = torch.zeros_like(ref).index_put_((idx,), g.double().abs(), accumulate=True)
        a = gather.gather_backward(g, idx, shape)
        b = gather.gather_backward(g, idx, shape)
        torch.cuda.synchronize(dev)
        err = float(((a.double() - ref).abs() / scale).max())

        def kernel():
            gather.gather_backward(g, idx, shape)

        ms = (device_ms(kernel, "gather_backward_partial", dev)
              + device_ms(kernel, "gather_backward_sum", dev))
        bound_ms, bound_by = bound(n * (4 * 3 + idx.element_size()), 0)
        fields = dict(
            lanes=n, rows=rows, index=str(dtype).split(".")[1], bit_equal=torch.equal(a, b),
            max_rel_err=err, ms=round(ms, 5), bound_ms=round(bound_ms, 5),
            bound_by=bound_by, call_ms=round(call_ms(kernel, dev), 5),
            plain_ms=round(call_ms(lambda: gather.gather_backward_plain(g, idx, shape), dev,
                                   reps=3), 4),
            index_add_ms=round(call_ms(lambda: torch.zeros(shape, device=dev).index_add_(
                0, idx, g), dev), 5))
        say("gather_kernel", **fields)
        if not fields["bit_equal"] or not err <= 1e-5:
            raise AssertionError(f"gather backward kernel: {fields}")
        if (n, rows, dtype) == (1 << 21, 4, torch.int64):
            report = fields
    g1 = torch.rand((32, 3), device=dev)
    i1 = torch.zeros((32,), dtype=torch.int64, device=dev)

    def one_warp():
        gather.gather_backward(g1, i1, torch.Size((1, 3)))

    report["floor_ms"] = round(device_ms(one_warp, "gather_backward_partial", dev)
                               + device_ms(one_warp, "gather_backward_sum", dev), 5)
    say("gather_kernel_floor", ms=report["floor_ms"])
    return {"gather_backward": report}


def phase_draw_kernel(dev):
    """The samplers' draw kernel (core/rng.py, csrc/rng_draw.cu) at the
    render chunks' lane counts, 2^18 (the sphere's image) and 2^19 (a
    Cornell chunk), with the main path's parts (a scalar seed, int64 pixel
    and sample indices, a scalar dim): `uniform` and `hash_u32` against
    their int64 twins bit for bit, the kernel's device ms (torch.profiler)
    beside its byte bound (the two index tensors read once, the floats
    written once), one wrapper call (CUDA events) and the twin's call
    (~96 elementwise launches), and the floor on one warp of lanes.
    Returns the entry's report at 2^19 lanes."""
    import torch

    from mitsuba_tpu_torch.core import rng

    report = {}
    for n in (1 << 18, 1 << 19):
        gen = torch.Generator(device=dev).manual_seed(n)
        pix = torch.randint(0, 1 << 16, (n,), generator=gen, device=dev)
        smp = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev)
        parts = (0x5EED, pix, smp, 6)
        bit_equal = (torch.equal(rng.uniform(*parts), rng.uniform_plain(*parts))
                     and torch.equal(rng.hash_u32(*parts), rng.hash_u32_plain(*parts)))

        def kernel():
            rng.uniform(*parts)

        bound_ms, bound_by = bound(n * (8 + 8 + 4), 0)
        fields = dict(
            lanes=n, bit_equal=bit_equal, ms=round(device_ms(kernel, "draw_kernel", dev), 5),
            bound_ms=round(bound_ms, 5), bound_by=bound_by,
            call_ms=round(call_ms(kernel, dev), 5),
            plain_ms=round(call_ms(lambda: rng.uniform_plain(*parts), dev), 5))
        say("draw_kernel", **fields)
        if not bit_equal:
            raise AssertionError(f"draw kernel: {fields}")
        report = fields
    one = torch.arange(32, device=dev)
    report["floor_ms"] = round(device_ms(lambda: rng.uniform(1, one, one, 0), "draw_kernel",
                                         dev), 5)
    say("draw_kernel_floor", ms=report["floor_ms"])
    return {"rng_draw": report}


def tri_rows(n_tris, seed):
    """(9, T) float32 rows p0 e1 e2 of random triangles in [-1, 1]^3."""
    rs = np.random.RandomState(seed)
    p0 = rs.uniform(-1, 1, (n_tris, 3))
    e = rs.uniform(-0.3, 0.3, (n_tris, 6))
    return np.concatenate([p0, e], 1).T.astype(np.float32)


def rays_at(rows, n, seed):
    """n rays from [-1.2, 1.2]^3: even ones aimed at a random point of a
    random triangle of the (9, T) rows, odd ones in random directions;
    limits in [0.05, 2)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1.2, 1.2, (n, 3))
    pick = rs.randint(0, rows.shape[1], n)
    b = rs.dirichlet((1.0, 1.0, 1.0), n)
    target = rows[0:3, pick].T + b[:, 1:2] * rows[3:6, pick].T + b[:, 2:3] * rows[6:9, pick].T
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o, rs.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rs.uniform(0.05, 2.0, n)


def phase_kernel_edges(dev):
    """The edges of the redesigned kernels, each against its plain twin bit
    for bit. B1: T of 1, 31, 32, 33, 1,156, 4,096 and 7,000 (above one
    tile of shared memory: the tiled loop), 10,007 rays (a multiple of no
    block and no lane count), opacity masks with holes, every lane count
    and the launcher's own choice; and triangles repeated in three chunks,
    whose keys tie, where the lowest chunk must win. B2: grazing rays along
    the displaced sphere (deep stacks), a quarter of each class retired,
    all three entries."""
    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    n = 10_007
    cases = [(f"random_{t}", tri_rows(t, t), t) for t in (1, 31, 32, 33, 1156, 4096, 7000)]
    dup = tri_rows(128, 7)
    cases.append(("repeated_3x128", np.concatenate([dup, dup, dup], 1), 128))
    bad, tiles = {}, {}
    for name, rows, seed in cases:
        tris = f32(rows)
        o, d, limit = (f32(a) for a in rays_at(rows, n, seed))
        tmax = torch.full((n,), 3.0e38, device=dev)
        rs = np.random.RandomState(seed + 1)
        opaque = torch.as_tensor(rs.uniform(size=rows.shape[1]) < 0.6, device=dev)
        pkey, pbase = bk.closest_key_plain(tris, o, d, tmax)
        pblocked = bk.any_hit_plain(tris, opaque, o, d, limit)
        for lanes in (None, *bk.LANES):
            key, base = bk.closest_key(tris, o, d, tmax, lanes=lanes)
            blocked = bk.any_hit(tris, opaque, o, d, limit, lanes=lanes)
            miss = (int(((key != pkey) | (base != pbase)).sum())
                    + int((blocked != pblocked).sum()))
            bad[f"{name}/{lanes or 'auto'}"] = miss
            tiles[name] = bk.LAST_CONFIG["closest"]["tile"]
        hits = (pkey & ~127) != 0x7F000000
        if name.startswith("repeated") and (not bool(hits.any()) or bool(pbase[hits].any())):
            raise AssertionError("repeated triangles: the first chunk did not win every tie")
    say("kernel_edges", rays=n, mismatches=sum(bad.values()), cases=len(bad), tiles=tiles)
    if any(bad.values()) or tiles["random_7000"] >= 7000:
        raise AssertionError(f"brute kernel edges: {bad}, tiles {tiles}")

    scene, _ = builtin.displaced_sphere(device=dev)
    closest, shadow = grazing_rays(65_536, 5, dev)
    compare_bvh("grazing", scene.bvh, closest, shadow)


def grazing_rays(n, seed, dev):
    """Rays that skim the displaced sphere (radius 1 +- 0.15 about the
    origin): from 3 units back along a tangent, at a height of 0.95-1.15
    over a random point of the unit sphere, along the tangent. Returns
    (closest, shadow) batches (o, d, tmax / distance); a quarter of each
    retired (0)."""
    import torch

    rs = np.random.RandomState(seed)
    u = rs.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    t = np.cross(u, rs.normal(size=(n, 3)))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    o = rs.uniform(0.95, 1.15, (n, 1)) * u - 3.0 * t
    k = np.arange(n)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    closest = (f32(o), f32(t), f32(np.where(k % 4 == 0, 0.0, 3.0e37)))
    shadow = (f32(o[::-1]), f32(t[::-1]), f32(np.where(k % 4 == 1, 0.0, 6.0)))
    return closest, shadow


def phase_crossover(dev):
    """Brute force (B1) against the BVH walk (B2) on the same meshes and
    the render's batches (65,536 bounce rays, closest; 65,536 shadow rays,
    any-hit): device ms per launch on the displaced sphere at 172, 356,
    724, 4,516 and 12,100 triangles, around and below
    trace.BRUTE_MAX_TRIS (4,096), which this measures and does not change.
    The two must agree at tests/test_bvh.py's bars."""
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.ops import bvh_traverse as bt
    from mitsuba_tpu_torch.ops import intersect
    from mitsuba_tpu_torch.scene import builtin

    rows = []
    for nu, nv in ((12, 8), (16, 12), (24, 16), (48, 48), (96, 64)):
        scene, cam = builtin.displaced_sphere(nu, nv, device=dev)
        _, (o, d, tmax), (o_s, d_s, dist) = render_rays(scene, cam, 4, 2, dev)
        limit = (dist * (1.0 - 1e-3)).contiguous()
        tris = intersect.tri_soa(scene)
        ms = {
            "b1_closest_ms": device_ms(lambda: bk.closest_key(tris, o, d, tmax),
                                       KERNELS["brute_closest"][3], dev),
            "b1_any_hit_ms": device_ms(
                lambda: bk.any_hit(tris, scene.tri_opaque, o_s, d_s, limit),
                KERNELS["brute_any_hit"][3], dev),
            "b2_closest_ms": device_ms(lambda: bvk.closest_key(scene.bvh, o, d, tmax),
                                       KERNELS["bvh_closest"][3], dev),
            "b2_any_hit_ms": device_ms(lambda: bvk.blocked(scene.bvh, o_s, d_s, limit),
                                       KERNELS["bvh_any_hit"][3], dev),
        }
        ref = intersect._finish_closest(scene, *bk.closest_key(tris, o, d, tmax), o.shape[0])
        its = bt.decode(scene.bvh, *bvk.closest_key(scene.bvh, o, d, tmax))
        agree = min(float((ref.valid == its.valid).float().mean()),
                    float((bk.any_hit(tris, scene.tri_opaque, o_s, d_s, limit)
                           == bvk.blocked(scene.bvh, o_s, d_s, limit)).float().mean()))
        say("crossover", tris=scene.num_triangles, rays=o.shape[0],
            **{k: round(v, 5) for k, v in ms.items()}, agree=agree,
            b1_config=dict(bk.LAST_CONFIG))
        if agree <= BVH_AGREE:
            raise AssertionError(f"crossover: B1 and B2 agree on {agree} of the rays")
        rows.append((scene.num_triangles, ms))
    return rows


def check_golden(img, ref):
    diff = np.abs(img - ref)
    off = (diff > GOLDEN_TOL + GOLDEN_TOL * np.abs(ref)).any(-1)
    if off.sum() > GOLDEN_MAX_FLIPS or diff.max() >= GOLDEN_MAX_FLIP:
        raise AssertionError(f"golden: {int(off.sum())} pixels off "
                             f"{np.argwhere(off).tolist()[:8]}, max diff {diff.max()}")
    return int(off.sum()), float(diff.max())


def phase_golden(dev):
    """tools/golden_scenes.py's cornell_path config through the wavefront,
    and its cornell_direct config through the direct integrator."""
    from mitsuba_tpu_torch.integrators import common, direct, wavefront
    from mitsuba_tpu_torch.scene import builtin

    ref = np.load(ROOT / "tests" / "golden" / "cornell_path.npy")
    scene, cam = builtin.cornell_box(width=32, height=32, device=dev)
    cfg = common.RenderConfig(spp=64, max_depth=8, rr_depth=5, seed=7)
    img = wavefront.render(scene, cam, cfg).cpu().numpy()
    flips, max_diff = check_golden(img, ref)
    ref_d = np.load(ROOT / "tests" / "golden" / "cornell_direct.npy")
    img_d = common.render(scene, cam, direct.li,
                          common.RenderConfig(spp=64, max_depth=2, seed=7)).cpu().numpy()
    flips_d, max_diff_d = check_golden(img_d, ref_d)
    say("golden", shape=list(img.shape), pixels_off=flips, max_abs_diff=max_diff,
        direct_pixels_off=flips_d, direct_max_abs_diff=max_diff_d)


def useful_rays_per_sample(scene, cam, cfg, count_spp):
    """Useful rays (closest-hit lanes + NEE shadow rays) per sample, counted
    with li_with_stats on a count_spp-sample subset of every pixel."""
    import torch

    from mitsuba_tpu_torch.core.rng import SampleStream
    from mitsuba_tpu_torch.integrators import path
    from mitsuba_tpu_torch.models import sensor

    w, h = cam.width, cam.height
    dev = scene.device
    pids = torch.repeat_interleave(torch.arange(w * h, device=dev), count_spp)
    slot = torch.arange(count_spp, device=dev).repeat(w * h)
    stream = SampleStream(cfg.seed, pids, slot, 0)
    jx, jy = stream.next_1d(), stream.next_1d()
    u_lens = stream.next_2d()
    o, d, _ = sensor.sample_rays(cam, (pids % w).float() + jx,
                                 (pids // w).float() + jy, u_lens)
    _, rays = path.li_with_stats(scene, cam, o, d, stream, cfg)
    return rays.item() / (w * h * count_spp)


def bf16_camera():
    """Emulate the TPU's default-precision float32 matmul (operands rounded
    to bfloat16, products summed in float32) in the camera rotation, the
    one matmul on the path."""
    import torch

    from mitsuba_tpu_torch.models import sensor

    def rotate(v, rot):
        return v.to(torch.bfloat16).float() @ rot.to(torch.bfloat16).float().T

    return mock.patch.object(sensor, "_rotate", rotate)


def phase_headline(dev, width, spp):
    """The headline render through the kernels; the main path must launch
    both and take the plain route never."""
    import torch

    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.integrators import common, wavefront
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(width=width, height=width, device=dev)
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    bk.reset_counts()
    rng.reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    img = wavefront.render(scene, cam, cfg, lanes_per_pixel=1)
    torch.cuda.synchronize(dev)
    render_s = time.perf_counter() - t0
    launches = dict(bk.KERNEL_LAUNCHES)
    plain = dict(bk.PLAIN_CALLS)
    draws = {"launches": rng.KERNEL_LAUNCHES["draw"], "lanes": rng.KERNEL_LANES["draw"],
             "plain_calls": rng.PLAIN_CALLS["draw"]}
    rays_per_sample = useful_rays_per_sample(scene, cam, cfg, count_spp=8)
    mean = float(img.mean())
    bk.reset_counts()
    with bf16_camera():
        img_bf16 = wavefront.render(scene, cam, cfg, lanes_per_pixel=1)
    mean_bf16 = float(img_bf16.mean())
    launches_bf16 = dict(bk.KERNEL_LAUNCHES)
    plain_bf16 = dict(bk.PLAIN_CALLS)
    useful = rays_per_sample * width * width * spp
    say("headline", resolution=f"{width}x{width}", spp=spp, render_s=round(render_s, 4),
        mean_radiance=round(mean, 6), mean_radiance_bf16_camera=round(mean_bf16, 6),
        tpu_mean=HEADLINE_MEAN, rays_per_sample=round(rays_per_sample, 4),
        useful_rays_per_s=round(useful / render_s), kernel_launches=launches,
        plain_calls=plain, bf16_camera_kernel_launches=launches_bf16,
        bf16_camera_plain_calls=plain_bf16, draws=draws)
    for what, im in (("headline image", img), ("bf16-camera image", img_bf16)):
        if not bool(torch.isfinite(im).all()) or tuple(im.shape) != (width, width, 3):
            raise AssertionError(f"{what}: shape {tuple(im.shape)}, "
                                 f"finite {bool(torch.isfinite(im).all())}")
    if abs(mean_bf16 - HEADLINE_MEAN) > HEADLINE_MEAN_RTOL * HEADLINE_MEAN:
        raise AssertionError(f"headline mean with the TPU's camera rounding {mean_bf16} "
                             f"is not within 1% of {HEADLINE_MEAN}")
    if abs(mean - HEADLINE_MEAN) > HEADLINE_F32_MEAN_RTOL * HEADLINE_MEAN:
        raise AssertionError(f"float32 headline mean {mean} is not within 2% "
                             f"of {HEADLINE_MEAN}")
    for counts, calls in ((launches, plain), (launches_bf16, plain_bf16)):
        if min(counts.values()) == 0 or any(calls.values()):
            raise AssertionError(f"main path bypassed a kernel: launches {counts}, "
                                 f"plain calls {calls}")
    if draws["launches"] == 0 or draws["plain_calls"]:
        raise AssertionError(f"main path bypassed the draw kernel: {draws}")
    EAGER_IMAGES["headline"] = (img, cfg, {f"brute_{k}": v for k, v in launches.items()})
    return launches


def device_times(prof, labels=()):
    """(kernel -> device ns, {label: device ns}) from the profiler's raw
    events, read once (key_averages builds a Python object per event,
    ~70 us each, half a minute on a grid render's ~10^6 events). A
    record_function range also appears on the device as a span from its
    first kernel to its last, idle gaps included: it is not a kernel. A
    label's device time is that of the kernels starting inside its spans,
    which on one stream are the range's own."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    per_kernel, kernels, spans = {}, [], {label: [] for label in labels}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if name in spans:
            spans[name].append((start, start + dur))
            continue
        per_kernel[name] = per_kernel.get(name, 0) + dur
        kernels.append((start, dur))
    starts = np.asarray([k[0] for k in kernels], np.int64)
    durs = np.asarray([k[1] for k in kernels], np.int64)
    in_label = {}
    for label, sp in spans.items():
        sp = np.asarray(sorted(sp), np.int64).reshape(-1, 2)
        at = np.searchsorted(sp[:, 0], starts, side="right") - 1
        inside = (at >= 0) & (starts < sp[np.maximum(at, 0), 1]) if len(sp) else at < -1
        in_label[label] = int(durs[inside].sum())
    return per_kernel, in_label


def phase_profile(name, scene, cam, cfg, li=None, scopes=None, **render_kw):
    """Device busy share of one render (profile_call): the wavefront's, or
    common.render's with the integrator `li`. Returns profile_call's
    scope shares."""
    from mitsuba_tpu_torch.integrators import common, wavefront

    def render():
        if li is None:
            return wavefront.render(scene, cam, cfg, **render_kw)
        return common.render(scene, cam, li, cfg)

    return profile_call(name, render, scene.device, scopes,
                        resolution=f"{cam.width}x{cam.height}", spp=cfg.spp)


def profile_call(name, render, dev, scopes=None, **fields):
    """Device busy share of one call of render() (torch.profiler, CUDA
    kernel time / wall time of the same call without the profiler).
    gather_share: the device time of torch's indexing and gather kernels
    over all kernels'. scopes {name: (module, function name)}: during the
    profiled call each function runs inside a profiler range of that name,
    and the device time of its kernels is printed as a share of all
    (device_times). `fields` join the printed line. Returns {name: share}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def in_range(label, fn):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    # the profiler slows the host side; its device time is divided by the
    # wall time of the same call without it
    with contextlib.ExitStack() as stack:
        for label, (mod, fn) in (scopes or {}).items():
            stack.enter_context(mock.patch.object(mod, fn, in_range(label, getattr(mod, fn))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize(dev)
    per_kernel, in_label = device_times(prof, scopes or {})
    device_ns = sum(per_kernel.values())
    gather_ns = sum(t for k, t in per_kernel.items()
                    if "index" in k.lower() or "gather" in k.lower())
    shares = {label: round(t / device_ns, 4) for label, t in in_label.items()}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    PROFILE_BUSY[name] = round(device_ns / 1e9 / wall_s, 4)
    say("profile", render=name, **fields,
        wall_s=round(wall_s, 4), device_busy_s=round(device_ns / 1e9, 4),
        busy_share=round(device_ns / 1e9 / wall_s, 4),
        gather_share=round(gather_ns / device_ns, 4),
        **({"scope_share": shares} if scopes else {}),
        top_ms=[(k[:48], round(t / 1e6, 2)) for k, t in top])
    return shares


def cornell_headline(dev, width, spp):
    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(width=width, height=width, device=dev)
    return scene, cam, common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)


def phase_mesh(dev, width, spp):
    """sphere_shadow(24, 24) (1,156 triangles) rendered through the kernels
    and through the plain version on the card: the images agree."""
    from mitsuba_tpu_torch.integrators import common, wavefront
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam, _ = builtin.sphere_shadow(24, 24, width=width, height=width, device=dev)
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    img = wavefront.render(scene, cam, cfg)
    # the wrappers send CUDA tensors to the kernel; swap in the plain twins
    with mock.patch.object(bk, "closest_key", bk.closest_key_plain), \
            mock.patch.object(bk, "any_hit", bk.any_hit_plain):
        ref = wavefront.render(scene, cam, cfg)
    diff = float((img - ref).abs().max())
    say("mesh", scene="sphere_shadow_24", resolution=f"{width}x{width}", spp=spp,
        mean=round(float(img.mean()), 6), max_abs_diff_vs_plain=diff)
    if not diff <= 1e-5:
        raise AssertionError(f"sphere_shadow: kernel and plain renders differ by {diff}")


def render_rays(scene, cam, lanes, seed, dev):
    """The big-mesh wavefront's batches at its shapes: one camera ray per
    lane (lanes x pixels, jittered), then, from each camera hit, a bounce
    ray (uniform over the hemisphere of the geometric normal) and the NEE
    shadow ray (emitter.sample_direct, limit its distance). Lanes whose
    camera ray missed carry retired rays (tmax 0), as the render's do.
    Returns (camera, bounce, shadow), each (o, d, tmax)."""
    import torch

    from mitsuba_tpu_torch.models import emitter, sensor
    from mitsuba_tpu_torch.ops import bvh_kernel, trace

    w, h = cam.width, cam.height
    n = w * h * lanes
    rs = np.random.RandomState(seed)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    pix = np.tile(np.arange(w * h), lanes)
    o, d, _ = sensor.sample_rays(cam, f32(pix % w + rs.uniform(size=n)),
                                 f32(pix // w + rs.uniform(size=n)), f32(np.zeros((n, 2))))
    cam_tmax = torch.full((n,), 3e37, device=dev)
    its = bvh_kernel.closest_hit(scene, scene.bvh, o, d, cam_tmax)
    si = trace.surface_interaction(scene, o, d, its)
    p, ng = si["p"], si["ng"]
    v = f32(rs.normal(size=(n, 3)))
    v = v / v.norm(dim=-1, keepdim=True)
    v = torch.where((v * ng).sum(-1, keepdim=True) < 0, -v, v)
    live = its.valid
    bounce = ((p + ng * 1e-3).contiguous(), v.contiguous(),
              torch.where(live, 3e37, 0.0))
    ds = emitter.sample_direct(scene, p, f32(rs.uniform(size=(n, 3))))
    shadow = (p.contiguous(), ds.d.contiguous(),
              torch.where(live & (ds.pdf > 0), ds.dist, 0.0))
    return (o, d, cam_tmax), bounce, shadow


def compare_bvh(name, bvh, closest, shadow, reps=0):
    """The three BVH entries and the plain walk on the same rays: raise
    unless key, base and blocked are equal bit for bit. With reps, time
    each entry and its plain version (CUDA events). Returns the errors,
    times and the walk's work (node visits, triangle tests)."""
    import torch

    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.ops import bvh_traverse as bt

    o, d, tmax = closest
    o_s, d_s, dist = shadow
    limit = (dist * (1.0 - 1e-3)).contiguous()
    n_c, n_s = o.shape[0], o_s.shape[0]
    key, base = bvk.closest_key(bvh, o, d, tmax)
    blocked = bvk.blocked(bvh, o_s, d_s, limit)
    fkey, fbase, fblocked = bvk.closest_and_any_key(bvh, o, d, tmax, o_s, d_s, limit)
    work = {"closest": {}, "any_hit": {}, "closest_and_any": {}}
    pkey, pbase, _ = bt.walk(bvh, o, d, tmax, n_c, work["closest"])
    pblocked = bt.walk(bvh, o_s, d_s, limit, 0, work["any_hit"])[2]
    fused_plain = bt.walk(bvh, torch.cat([o, o_s]), torch.cat([d, d_s]),
                          torch.cat([tmax, limit]), n_c, work["closest_and_any"])
    torch.cuda.synchronize()
    bad = {
        "closest_key_mismatch": int(((key != pkey) | (base != pbase)).sum()),
        "any_hit_blocked_mismatch": int((blocked != pblocked).sum()),
        "fused_key_mismatch": int(((fkey != fused_plain[0][:n_c])
                                   | (fbase != fused_plain[1][:n_c])).sum()),
        "fused_blocked_mismatch": int((fblocked != fused_plain[2][n_c:]).sum()),
    }
    t_k = bt.decode(bvh, key, base).t
    t_p = bt.decode(bvh, pkey, pbase).t
    hit = t_p < 1e30
    t_err = float((t_k - t_p)[hit].abs().max()) if bool(hit.any()) else 0.0
    errs = {"bvh_closest": t_err,
            "bvh_any_hit": float((blocked.int() - pblocked.int()).abs().max()),
            "bvh_closest_and_any": max(
                float((bt.decode(bvh, fkey, fbase).t - t_p)[hit].abs().max())
                if bool(hit.any()) else 0.0,
                float((fblocked.int() - pblocked.int()).abs().max()))}
    times = {}
    if reps:
        dev = o.device
        entries = {
            "bvh_closest": (lambda: bvk.closest_key(bvh, o, d, tmax),
                            lambda: bt.walk(bvh, o, d, tmax, n_c)),
            "bvh_any_hit": (lambda: bvk.blocked(bvh, o_s, d_s, limit),
                            lambda: bt.walk(bvh, o_s, d_s, limit, 0)),
            "bvh_closest_and_any": (
                lambda: bvk.closest_and_any_key(bvh, o, d, tmax, o_s, d_s, limit),
                lambda: bt.walk(bvh, torch.cat([o, o_s]), torch.cat([d, d_s]),
                                torch.cat([tmax, limit]), n_c)),
        }
        # (device ms, call ms, plain ms) of each entry
        times = {k: (device_ms(fn, KERNELS[k][3], dev, reps), call_ms(fn, dev, reps),
                     call_ms(plain, dev, 2)) for k, (fn, plain) in entries.items()}
    say("bvh_kernel", rays=name, closest_rays=n_c, shadow_rays=n_s,
        hit_frac=round(float(hit.float().mean()), 4),
        blocked_frac=round(float(pblocked.float().mean()), 4),
        t_max_abs_err=t_err, **bad, walk_work=work,
        **{f"{k}_ms": round(v[0], 5) for k, v in times.items()},
        **{f"{k}_call_ms": round(v[1], 5) for k, v in times.items()},
        **{f"{k}_plain_ms": round(v[2], 2) for k, v in times.items()})
    if any(bad.values()):
        raise AssertionError(f"bvh kernel and plain walk differ on {name}: {bad}")
    return errs, times, work


def bvh_bounds(bvh, n_c, n_s, work):
    """Bounds of the three BVH entries: the wide-node and leaf tables read
    once plus rays in and results out, against the child box tests and
    triangle tests this run's walk made (the twin's counts)."""
    tables = (bvh.wide.numel() * 4 + bvh.leaf_tris.numel() * 4
              + bvh.leaf_opaque.numel())

    def one(w, n_bytes):
        return bound(tables + n_bytes,
                     w.get("box_tests", 0) * SLAB_INSTR + w.get("tri_tests", 0) * TRI_INSTR)

    return {"bvh_closest": one(work["closest"], n_c * (RAY_BYTES + 8)),
            "bvh_any_hit": one(work["any_hit"], n_s * (RAY_BYTES + 1)),
            "bvh_closest_and_any": one(work["closest_and_any"],
                                       n_c * (RAY_BYTES + 8) + n_s * (RAY_BYTES + 1))}


def phase_bvh_kernel(dev):
    """The BVH kernel on the 70,034-triangle displaced sphere: against its
    plain walk bit for bit on random rays and on the render's batches
    (65,536 closest + 65,536 shadow rays, the main path's shapes), timed
    there; and against the brute-force kernel (the exact reference) on
    2^16 rays, at tests/test_bvh.py's bars."""
    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.ops import intersect
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.displaced_sphere(device=dev)
    bvh = scene.bvh
    n = cam.width * cam.height * 4
    o, d, limit = kernel_rays(scene, n, 70034, dev)
    tmax = torch.full((n,), 3.0e38, device=dev)
    errs_r, _, _ = compare_bvh("kernel_rays", bvh, (o, d, tmax), (o, d, limit))
    camera, bounce, shadow = render_rays(scene, cam, 4, 1, dev)
    errs_c, _, _ = compare_bvh("camera_and_shadow", bvh, camera, shadow)
    errs, times, work = compare_bvh("bounce_and_shadow", bvh, bounce, shadow, reps=20)
    bounds = bvh_bounds(bvh, n, n, work)

    # against brute force (exact; the same quantised key), on random rays
    its = bvk.closest_hit(scene, bvh, o, d, tmax)
    blocked = bvk.blocked(bvh, o, d, limit)
    tris = intersect.tri_soa(scene)
    rkey, rbase = bk.closest_key(tris, o, d, tmax)
    ref = intersect._finish_closest(scene, rkey, rbase, n)
    ref_blocked = bk.any_hit(tris, scene.tri_opaque, o, d, limit)
    both = ref.valid & its.valid
    valid_agree = float((ref.valid == its.valid).float().mean())
    prim_agree = float((ref.prim == its.prim)[both].float().mean())
    blocked_agree = float((ref_blocked == blocked).float().mean())
    t_ok = bool(torch.allclose(its.t[both], ref.t[both], rtol=BVH_T_RTOL, atol=BVH_T_ATOL))
    say("bvh_vs_brute", tris=scene.num_triangles, rays=n,
        valid_mismatch=int((ref.valid != its.valid).sum()),
        prim_mismatch=int((ref.prim != its.prim)[both].sum()),
        blocked_mismatch=int((ref_blocked != blocked).sum()),
        t_max_rel_err=float(((its.t - ref.t).abs() / ref.t)[both].max()),
        t_within_bars=t_ok, hit_frac=round(float(ref.valid.float().mean()), 4))
    if min(valid_agree, prim_agree, blocked_agree) <= BVH_AGREE or not t_ok:
        raise AssertionError("bvh kernel and brute force disagree beyond "
                             "tests/test_bvh.py's bars")
    say("bvh_bound", rays=n, **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
        **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
        **{f"{k}_{w}": work[k.replace("bvh_", "")].get(w, 0)
           for k in bounds for w in ("visits", "box_tests", "tri_tests", "max_stack")})
    report = {}
    for k in bounds:
        report[k] = {"max_abs_err": max(errs[k], errs_r[k], errs_c[k]),
                     "ms": times[k][0], "call_ms": times[k][1], "plain_ms": times[k][2],
                     "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                     "library_ms": None}
    return report


def phase_bigmesh(dev, lanes=4):
    """bench.py's bigmesh render at full size through the port: useful
    rays per sample (li_with_stats on 2 spp of every pixel, the bench's
    protocol) and the fused, compacted wavefront render, timed; then the
    same render with the TPU's bfloat16 camera rounding, whose mean is
    held to 1% of the TPU's. The two are separate paths and are counted
    apart, each with the counts zeroed just before it and read just after:
    the render must launch the fused entry, the count pass (the path
    integrator, unfused) the closest and any-hit entries; neither may take
    the plain walk or launch brute force. Returns the launches of each."""
    import torch

    from mitsuba_tpu_torch.integrators import common, wavefront
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.displaced_sphere(device=dev)
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
    kw = dict(lanes_per_pixel=lanes, compact=True, fuse=True)
    wavefront.render(scene, cam, cfg, **kw)   # warm-up, as the bench does

    def timed_render():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        img = wavefront.render(scene, cam, cfg, **kw)
        torch.cuda.synchronize(dev)
        return img, time.perf_counter() - t0

    def reset():
        for counts in (bk, bvk):
            counts.reset_counts()

    def read():
        return dict(bvk.KERNEL_LAUNCHES), dict(bvk.PLAIN_CALLS), dict(bk.KERNEL_LAUNCHES)

    # as bench.py measures it: the useful-ray count (path.li_with_stats),
    # then the render, each path counted on its own
    reset()
    rays_per_sample = useful_rays_per_sample(scene, cam, cfg, count_spp=2)
    count_launches, count_plain, count_brute = read()
    reset()
    img, render_s = timed_render()
    launches, plain, brute = read()
    steps = launches["closest_and_any"]
    # host-bound: the clock varies from render to render; the median of
    # three (the counted one first) is the figure
    renders_s = [render_s, timed_render()[1], timed_render()[1]]
    render_s = sorted(renders_s)[1]
    mean = float(img.mean())
    with bf16_camera():
        img_bf16 = wavefront.render(scene, cam, cfg, **kw)
    mean_bf16 = float(img_bf16.mean())
    useful = rays_per_sample * cam.width * cam.height * cfg.spp
    say("bigmesh", tris=scene.num_triangles, resolution=f"{cam.width}x{cam.height}",
        spp=cfg.spp, max_depth=cfg.max_depth, lanes=lanes, fuse=True, compact=True,
        render_s=round(render_s, 4), renders_s=[round(x, 4) for x in renders_s],
        rays_per_sample=round(rays_per_sample, 4),
        useful_rays_per_s=round(useful / render_s), steps=steps,
        bvh_kernel_launches=launches, bvh_plain_calls=plain, brute_launches=brute,
        count_pass_bvh_kernel_launches=count_launches,
        count_pass_bvh_plain_calls=count_plain, count_pass_brute_launches=count_brute,
        mean_radiance=round(mean, 8), mean_radiance_bf16_camera=round(mean_bf16, 8),
        tpu_mean=BIGMESH_MEAN)
    for what, im in (("bigmesh image", img), ("bf16-camera bigmesh image", img_bf16)):
        if not bool(torch.isfinite(im).all()) or tuple(im.shape) != (cam.height, cam.width, 3):
            raise AssertionError(f"{what}: shape {tuple(im.shape)}, "
                                 f"finite {bool(torch.isfinite(im).all())}")
    for what, ran, counts, calls, brute_counts in (
            ("render", launches["closest_and_any"], launches, plain, brute),
            ("count pass", min(count_launches["closest"], count_launches["any_hit"]),
             count_launches, count_plain, count_brute)):
        if ran == 0 or any(calls.values()) or any(brute_counts.values()):
            raise AssertionError(f"big-mesh {what} bypassed the BVH kernel: launches "
                                 f"{counts}, plain calls {calls}, brute launches "
                                 f"{brute_counts}")
    if abs(mean_bf16 - BIGMESH_MEAN) > BIGMESH_MEAN_RTOL * BIGMESH_MEAN:
        raise AssertionError(f"big-mesh mean with the TPU's camera rounding {mean_bf16} "
                             f"is not within 1% of {BIGMESH_MEAN}")
    phase_profile("bigmesh", scene, cam, cfg, **kw)
    EAGER_IMAGES["bigmesh"] = (img, cfg, {f"bvh_{k}": v for k, v in launches.items()})
    return {"bigmesh_render": launches, "bigmesh_count_pass": count_launches}


# Gradient phases. FD bars and protocols: tests/test_vertex_grad.py:143-172
# (quad blocker, 5%) and :373-492 (mesh scale, 10%; inverse recovery within
# 0.06 of the true translation).
GRAD_KERNEL_RTOL = 1e-4
GRAD_HEADLINE_SPP = 8
SHADOW_FD_RTOL = 0.05
MESH_FD_RTOL = 0.10
MESH_THETA_TRUE, MESH_THETA_TOL = 0.2, 0.06


def grad_leaves(scene):
    """(scene', leaves): scene' with fresh vertices, reflectances and
    radiances that require grad."""
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (scene.vertices, scene.materials.reflectance, scene.emitters.radiance)]
    return scene.replace(vertices=leaves[0],
                         materials=scene.materials.replace(reflectance=leaves[1]),
                         emitters=scene.emitters.replace(radiance=leaves[2])), leaves


def render_grads(scene, cam, cfg, bc):
    """Gradients of render_grad's mean with respect to the vertices,
    reflectances and radiances."""
    from mitsuba_tpu_torch.integrators import boundary

    s, leaves = grad_leaves(scene)
    boundary.render_grad(s, cam, cfg, bc).mean().backward()
    return [x.grad for x in leaves]


def plain_twins():
    """{(module, entry): plain twin} of the kernel entries the gradient
    paths launch: the brute-force entries' plain versions, and the BVH walk
    for the BVH entries. Each twin takes its entry's arguments, the rays
    o, d and tmax (or limit) last."""
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.ops import bvh_traverse as bt

    return {(bk, "closest_key"): bk.closest_key_plain,
            (bk, "any_hit"): bk.any_hit_plain,
            (bvk, "closest_key"): lambda bvh, o, d, tm: bt.walk(bvh, o, d, tm, o.shape[0])[:2],
            (bvk, "blocked"): lambda bvh, o, d, lim: bt.walk(bvh, o, d, lim, 0)[2]}


def plain_patched(mod):
    """A context in which the kernel entries of `mod` are their plain twins."""
    stack = contextlib.ExitStack()
    for (owner, entry), twin in plain_twins().items():
        if owner is mod:
            stack.enter_context(mock.patch.object(owner, entry, twin))
    return stack


def keeping_launches(mod):
    """(context, kept): within the context, the first call of each kernel
    entry of `mod` at each batch size keeps a copy of its arguments and
    results in kept[(entry, rays)], for check_kept. The call itself, and
    its launch count, are unchanged."""
    import torch

    kept = {}
    stack = contextlib.ExitStack()
    for owner, entry in plain_twins():
        if owner is not mod:
            continue

        def call(*args, _fn=getattr(owner, entry), _entry=entry):
            out = _fn(*args)
            key = (_entry, args[-1].shape[0])
            if key[1] and key not in kept:
                kept[key] = ([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                             [x.clone() for x in (out if isinstance(out, tuple) else (out,))])
            return out

        stack.enter_context(mock.patch.object(owner, entry, call))
    return stack, kept


def check_kept(mod, kept, chunk=1 << 20, entries=None):
    """Reruns each kept launch of `mod` through its plain twin, `chunk`
    rays at a time, and raises where a key, base or blocked differs, or
    where an entry of `mod` (of `entries`, where given) kept no launch.
    Returns {entry: the batch sizes checked}."""
    import torch

    twins = {entry: twin for (owner, entry), twin in plain_twins().items() if owner is mod}
    checked = {}
    for (entry, n), (args, outs) in sorted(kept.items(), key=lambda kv: kv[0]):
        parts = []
        for s in range(0, n, chunk):
            got = twins[entry](*args[:-3], *(a[s:s + chunk] for a in args[-3:]))
            parts.append(got if isinstance(got, tuple) else (got,))
        plain = [torch.cat(p) for p in zip(*parts)]
        differ = sum(int((a != b).sum()) for a, b in zip(outs, plain))
        if differ or len(plain) != len(outs):
            raise AssertionError(f"{entry} at {n} rays: {differ} results differ from "
                                 "the plain twin's")
        checked.setdefault(entry, []).append(n)
    if not set(twins if entries is None else entries) <= set(checked):
        raise AssertionError(f"launches kept of {sorted(twins)}: {sorted(checked)}")
    return checked


def phase_grad_kernels(dev):
    """The gradient of render_grad's mean through each kernel against the
    gradient with its plain twin patched in: B1 on Cornell (64x64, 4 spp,
    depth 8, the default BoundaryConfig), B2 on sphere_shadow with the BVH
    attached (10,372 triangles, 20x20, 4 spp, depth 2). Equal up to the
    summation order of the splat and of the gathers' backward (atomics):
    within GRAD_KERNEL_RTOL of each tensor's largest entry."""
    import torch

    from mitsuba_tpu_torch.integrators import boundary, common
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    cornell, cam_c = builtin.cornell_box(64, 64, device=dev)
    mesh, cam_m, _ = builtin.sphere_shadow(attach_bvh=True, device=dev)
    cases = (("b1_cornell", cornell, cam_c, common.RenderConfig(spp=4, max_depth=8, rr_depth=5),
              bk),
             ("b2_sphere_shadow", mesh, cam_m, common.RenderConfig(spp=4, max_depth=2), bvk))
    fields = {}
    for name, scene, cam, cfg, mod in cases:
        for counts in (bk, bvk):
            counts.reset_counts()
        grads = render_grads(scene, cam, cfg, boundary.BoundaryConfig())
        launches = dict(mod.KERNEL_LAUNCHES)
        other = bvk if mod is bk else bk
        if min(v for k, v in launches.items() if k != "closest_and_any") == 0 \
                or any(other.KERNEL_LAUNCHES.values()) or any(mod.PLAIN_CALLS.values()):
            raise AssertionError(f"{name}: the gradient step bypassed its kernel: {launches}")
        with plain_patched(mod):
            plain = render_grads(scene, cam, cfg, boundary.BoundaryConfig())
        rel = [float((g - q).abs().max() / q.abs().max()) for g, q in zip(grads, plain)]
        fields[name] = {"launches": launches, "rel_diff_v_r_e": rel,
                        "finite": all(bool(torch.isfinite(g).all()) for g in grads)}
        if max(rel) > GRAD_KERNEL_RTOL or not fields[name]["finite"]:
            raise AssertionError(f"{name}: kernel and plain gradients differ: {rel}")
    say("grad_kernels", tris={"b1_cornell": cornell.num_triangles,
                              "b2_sphere_shadow": mesh.num_triangles},
        rtol=GRAD_KERNEL_RTOL, **fields)


def shifted(scene, rows, theta):
    """scene with its vertex rows [rows) moved by theta along x (theta a
    float or a tensor that requires grad)."""
    import torch

    mask = torch.zeros_like(scene.vertices)
    mask[rows[0]:rows[1], 0] = 1.0
    return scene.replace(vertices=scene.vertices + theta * mask)


def mean_image(scene, cam, li, cfg):
    from mitsuba_tpu_torch.integrators import common

    return common.render(scene, cam, li, cfg).mean()


def theta_grad(scene, rows, theta0, cam, li, cfg):
    """d(mean image)/d(theta) of the rows' x-translation at theta0."""
    import torch

    theta = torch.tensor(float(theta0), device=scene.device, requires_grad=True)
    mean_image(shifted(scene, rows, theta - theta0), cam, li, cfg).backward()
    return float(theta.grad)


def li_grad_fn(bc):
    from mitsuba_tpu_torch.integrators import boundary

    return lambda s, c, o, d, st, cf: boundary.li_grad(s, c, o, d, st, cf, bc)


def phase_grad_shadow(dev):
    """tests/test_vertex_grad.py:143-172 on the card (B1): the quad blocker's
    x-translation moves only its shadow; central FD of the path render (768
    spp, eps 0.025, seed 7) against li_grad (n_edge 8, 64 spp, seeds 3 and
    11), within 5%; plain AD (path.li, 16 spp) sees under 5% of it."""
    import torch

    from mitsuba_tpu_torch.integrators import boundary, common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    scene, cam = shadow_scene(dev)
    eps = 0.025
    cfg_fd = common.RenderConfig(spp=768, max_depth=2, seed=7)
    with torch.no_grad():
        fd = (float(mean_image(shifted(scene, BLOCKER_ROWS, eps), cam, path.li, cfg_fd))
              - float(mean_image(shifted(scene, BLOCKER_ROWS, -eps), cam, path.li, cfg_fd))) \
            / (2 * eps)
    g0 = theta_grad(scene, BLOCKER_ROWS, 0.0, cam, path.li,
                    common.RenderConfig(spp=16, max_depth=2, seed=7))
    bk.reset_counts()
    bc = boundary.BoundaryConfig(n_edge=8, primary=False)
    gs = [theta_grad(scene, BLOCKER_ROWS, 0.0, cam, li_grad_fn(bc),
                     common.RenderConfig(spp=64, max_depth=2, seed=seed)) for seed in (3, 11)]
    g = float(np.mean(gs))
    launches = dict(bk.KERNEL_LAUNCHES)
    say("grad_shadow", fd=round(fd, 6), li_grad=round(g, 6), per_seed=[round(x, 6) for x in gs],
        rel_err=round(abs(g - fd) / abs(fd), 5), bar=SHADOW_FD_RTOL, plain_ad=round(g0, 6),
        b1_launches=launches)
    if not fd < -0.2 or abs(g0) >= 0.05 * abs(fd) or abs(g - fd) >= SHADOW_FD_RTOL * abs(fd):
        raise AssertionError(f"quad-blocker gradient {g} (plain AD {g0}) against FD {fd}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the shadow gradient bypassed B1: {launches}")


def phase_grad_mesh(dev):
    """tests/test_vertex_grad.py:373-492 on the card (B2): sphere_shadow's
    10,372 triangles with the BVH attached. The blocker's x-translation
    gradient at theta0 0.2: central FD (48 spp, eps 0.04, the BVH attached
    anew at each theta) against li_grad (n_edge 8, 24 spp, seeds 3, 11, 19,
    27, the vertices moved on theta0's tables), within 10%. Then the 8-step
    inverse recovery (16x16, target 48 spp seed 13, from theta 0.32, n_edge
    4, 8 spp, clipped steps) to within 0.06 of 0.2. The first launch of
    each BVH entry at each batch size of the gradient steps is rerun
    through the walk (check_kept), bit for bit. Returns the BVH kernel's
    launches in the gradient steps."""
    import torch

    from mitsuba_tpu_torch.integrators import boundary, common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin
    from mitsuba_tpu_torch.scene import bvh as bvhlib

    t0 = time.perf_counter()
    scene0, cam, rows = builtin.sphere_shadow(device=dev)
    theta0, eps = 0.2, 0.04
    cfg_fd = common.RenderConfig(spp=48, max_depth=2, seed=7)

    def scene_at(base, theta):
        return bvhlib.attach(shifted(base, rows, theta))

    with torch.no_grad():
        fd = (float(mean_image(scene_at(scene0, theta0 + eps), cam, path.li, cfg_fd))
              - float(mean_image(scene_at(scene0, theta0 - eps), cam, path.li, cfg_fd))) \
            / (2 * eps)
    base = scene_at(scene0, theta0)
    for counts in (bk, bvk):
        counts.reset_counts()
    bc = boundary.BoundaryConfig(n_edge=8, primary=False)
    keeping, kept = keeping_launches(bvk)
    with keeping:
        gs = [theta_grad(base, rows, theta0, cam, li_grad_fn(bc),
                         common.RenderConfig(spp=24, max_depth=2, seed=seed))
              for seed in (3, 11, 19, 27)]
    g = float(np.mean(gs))
    launches, plain, brute = dict(bvk.KERNEL_LAUNCHES), dict(bvk.PLAIN_CALLS), dict(bk.KERNEL_LAUNCHES)
    grad_s = time.perf_counter() - t0
    twin_checked = check_kept(bvk, kept)

    scene16, cam16, _ = builtin.sphere_shadow(width=16, height=16, device=dev)
    with torch.no_grad():
        target = common.render(scene_at(scene16, MESH_THETA_TRUE), cam16, path.li,
                               common.RenderConfig(spp=48, max_depth=2, seed=13))
    theta, lr, trail = 0.32, 3.0, []
    bc4 = boundary.BoundaryConfig(n_edge=4, primary=False)
    for it in range(8):
        at = scene_at(scene16, theta)
        th = torch.tensor(theta, device=dev, requires_grad=True)
        img = common.render(shifted(at, rows, th - theta), cam16, li_grad_fn(bc4),
                            common.RenderConfig(spp=8, max_depth=2, seed=it + 1))
        ((img - target) ** 2).mean().backward()
        step = float(np.clip(lr * float(th.grad), -0.05, 0.05))
        theta = float(np.clip(theta - step, 0.0, 0.5))
        lr *= 0.85
        trail.append(round(theta, 4))
    say("grad_mesh", tris=scene0.num_triangles, fd=round(fd, 6), li_grad=round(g, 6),
        per_seed=[round(x, 6) for x in gs], rel_err=round(abs(g - fd) / abs(fd), 5),
        bar=MESH_FD_RTOL, bvh_kernel_launches=launches, bvh_plain_calls=plain,
        brute_launches=brute, twin_checked_rays=twin_checked, twin_mismatches=0,
        fd_and_grad_s=round(grad_s, 3), inverse_theta=trail,
        inverse_err=round(abs(theta - MESH_THETA_TRUE), 5), inverse_bar=MESH_THETA_TOL)
    if not fd > 0.1 or abs(g - fd) >= MESH_FD_RTOL * abs(fd):
        raise AssertionError(f"mesh-scale gradient {g} against FD {fd}")
    if abs(theta - MESH_THETA_TRUE) >= MESH_THETA_TOL:
        raise AssertionError(f"inverse recovery ended at {theta}")
    if min(launches["closest"], launches["any_hit"]) == 0 or any(plain.values()) \
            or any(brute.values()):
        raise AssertionError(f"the mesh gradient bypassed B2: {launches}, plain {plain}, "
                             f"brute {brute}")
    return launches


def phase_grad_headline(dev, spp):
    """The README's use at the headline film: Cornell 256x256, depth 8,
    rr_depth 5, `spp` samples, an L2 loss against a target render (64 spp,
    seed 1) through boundary.render_grad with the default BoundaryConfig
    (n_edge 8, the splat pass with 16,384 samples), gradients with respect
    to the vertices, reflectances and radiances. Forward and backward
    seconds (host clock, synchronised), peak memory (peak_gb: the device's
    peak from the step's start; step_peak_gb: that less what was allocated
    at the step's start, the step's own), B1's launches, the
    device busy share of the step (torch.profiler's kernel time over the
    unprofiled step's wall time) and the bytes autograd saved for the
    backward (each storage once, counted in the profiled step). In the
    profiled step the first launch of each B1 entry at each batch size is
    kept and then rerun through the plain twin (check_kept), bit for bit.
    The gather backward's launches and lanes in the first step
    (ops/gather.py): every gather of a leaf-derived table goes through the
    kernel, none over its cap. Returns B1's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.integrators import boundary, common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import gather
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(256, 256, device=dev)
    cfg = common.RenderConfig(spp=spp, max_depth=8, rr_depth=5, seed=0)
    with torch.no_grad():
        target = common.render(scene, cam, path.li,
                               common.RenderConfig(spp=64, max_depth=8, rr_depth=5, seed=1))
    bc = boundary.BoundaryConfig()

    def step():
        s, leaves = grad_leaves(scene)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = ((boundary.render_grad(s, cam, cfg, bc) - target) ** 2).mean()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize(dev)
        return float(loss.detach()), [x.grad for x in leaves], t1 - t0, time.perf_counter() - t1

    bk.reset_counts()
    gather.reset_counts()
    rng.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    base_gb = torch.cuda.memory_allocated(dev) / 1e9
    loss, grads, fwd_s, bwd_s = step()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, plain = dict(bk.KERNEL_LAUNCHES), dict(bk.PLAIN_CALLS)
    draws = {"launches": rng.KERNEL_LAUNCHES["draw"], "lanes": rng.KERNEL_LANES["draw"],
             "plain_calls": rng.PLAIN_CALLS["draw"]}
    gathers = {"launches": gather.KERNEL_LAUNCHES["backward"],
               "lanes": gather.KERNEL_LANES["backward"], **gather.ROUTED_PLAIN}
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        saved[storage.data_ptr()] = storage.nbytes()
        return t

    keeping, kept = keeping_launches(bk)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), keeping:
        step()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    device_s = sum(e.device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    twin_checked = check_kept(bk, kept)
    del kept
    say("grad_headline", resolution="256x256", spp=spp, max_depth=8, loss=round(loss, 8),
        forward_s=round(fwd_s, 4), backward_s=round(bwd_s, 4),
        peak_gb=round(peak_gb, 3), step_peak_gb=round(peak_gb - base_gb, 3),
        saved_gb=round(sum(saved.values()) / 1e9, 3),
        b1_launches=launches, b1_plain_calls=plain, gather_backward=gathers, draws=draws,
        twin_checked_rays=twin_checked, twin_mismatches=0, device_busy_s=round(device_s, 4), busy_share=round(device_s / (fwd_s + bwd_s), 4),
        device_kernels=sum(e.count for e in kernels),
        top_ms=[(e.key[:48], round(e.device_time_total / 1e3, 2)) for e in top],
        grad_abs_max=[float(g.abs().max()) for g in grads], finite=finite)
    if not finite or min(launches.values()) == 0 or any(plain.values()) \
            or gathers["launches"] == 0 or gathers["over_cap"] or gathers["dtype"] \
            or draws["launches"] == 0 or draws["plain_calls"]:
        raise AssertionError(f"headline gradient: finite {finite}, launches {launches}, "
                             f"plain calls {plain}, gathers {gathers}, draws {draws}")
    return launches


# --- materials and lighting -------------------------------------------------

# tools/golden_scenes.py's envmap_textured geometry: a unit quad in y = 0 with
# uvs, seen from above at 40 degrees (also the quad of
# tests/test_baseline_configs.py:42's OBJ)
TEXTURED_QUAD = (np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32),
                 np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                 np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
TEXTURED_QUAD_CAMERA = dict(origin=[0, 2, -3], target=[0, 0, 0], fov_x=40)
# BASELINE's "Veach MIS microfacet sweep" sampling and the full envmap cell
VEACH_SPP = ENVMAP_SPP = 64
VEACH_DEPTH = ENVMAP_DEPTH = 3
# FD protocols: tests/test_grad_coverage.py:60-90 (roughness: AD 48 spp, FD
# 192 spp, eps 0.05, 15%) and tests/test_baseline_configs.py:42-77 (texel
# [0, 3, 3, 1]: 16 spp, eps 1e-2, 5%); tests/test_envmap.py:54 (2%)
ROUGH_FD_RTOL = 0.15
TEXEL_FD_RTOL = 0.05
ENV_TOTAL_RTOL = 2e-2


def golden_textures():
    """The envmap_textured golden's 8x8 texture and 8x16 envmap (numpy seed 0)."""
    rng = np.random.RandomState(0)
    tex = rng.uniform(0.2, 0.9, (8, 8, 3)).astype(np.float32)
    return tex, rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)


def lod_scale(cam):
    """The world width of one pixel at unit distance (the JAX loader's
    `_lod_scale`, scene/xml.py:1433)."""
    return 2.0 * float(np.tan(np.deg2rad(float(cam.fov_x)) / 2.0)) / max(cam.width, 1)


def textured_quad(dev, tex, env, width, height, mips=False):
    """The envmap_textured scene: TEXTURED_QUAD, diffuse with texture `tex`,
    under the lat-long map `env`; mips=True builds the mip strip for this
    camera (trilinear and EWA lookups). Returns (scene, camera)."""
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.scene import envmap, ir

    cam = sensor.make_camera(**TEXTURED_QUAD_CAMERA, width=width, height=height, device=dev)
    verts, tris, uvs = TEXTURED_QUAD
    scene = ir.build_scene(verts, tris, np.zeros(2, np.int32),
                           [{"type": ir.BSDF_DIFFUSE, "tex_reflectance": 0}], uvs=uvs,
                           textures=[{"data": tex}],
                           lod_scale=lod_scale(cam) if mips else None, device=dev)
    return envmap.attach_envmap(scene, env), cam


def roughness_scene(dev):
    """tests/test_grad_coverage.py:60's scene: a 0.25-rough conductor floor
    under a quad light, 16x16."""
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.scene import ir

    verts = np.asarray([[-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2],
                        [-0.4, 1.5, -0.4], [0.4, 1.5, -0.4], [0.4, 1.5, 0.4],
                        [-0.4, 1.5, 0.4]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    scene = ir.build_scene(verts, tris, np.zeros(4, np.int32),
                           [{"type": ir.BSDF_ROUGH_CONDUCTOR, "alpha": [0.25, 0.25],
                             "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14]}],
                           tri_radiance={2: [8.0] * 3, 3: [8.0] * 3}, device=dev)
    cam = sensor.make_camera(origin=[0, 1.0, 2.5], target=[0, 0, 0], fov_x=50.0,
                             width=16, height=16, device=dev)
    return scene, cam


def counted():
    """(context, read): zero B1's counts, keep the first launch of each
    entry at each batch size (keeping_launches); read() -> (launches,
    plain calls, kept)."""
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    bk.reset_counts()
    keeping, kept = keeping_launches(bk)

    def read():
        return dict(bk.KERNEL_LAUNCHES), dict(bk.PLAIN_CALLS), kept
    return keeping, read


def require_b1(what, launches, plain):
    if min(launches.values()) == 0 or any(plain.values()):
        raise AssertionError(f"{what} bypassed B1: launches {launches}, plain calls {plain}")


def phase_golden_materials(dev):
    """tools/golden_scenes.py's veach_mis (48x36, 64 spp, depth 3, seed 7)
    and envmap_textured (24x24) configs through path.li on the card,
    against tests/golden/*.npy at the golden bar (check_golden); caustic_box
    with a delta mirror and with a rough Beckmann one renders finite. B1
    carries every search; one launch of each entry at each batch size is
    rerun through its twin (check_kept)."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    cfg = common.RenderConfig(spp=64, max_depth=3, seed=7)
    keeping, read = counted()
    with keeping:
        veach = common.render(*builtin.veach_mis(48, 36, device=dev), path.li, cfg)
        textured = common.render(*textured_quad(dev, *golden_textures(), 24, 24), path.li, cfg)
        caustic = {rough: common.render(*builtin.caustic_box(64, 64, rough=rough, device=dev),
                                        path.li, common.RenderConfig(spp=16, max_depth=6, seed=0))
                   for rough in (False, True)}
    launches, plain, kept = read()
    out = {}
    for name, img in (("veach_mis", veach), ("envmap_textured", textured)):
        flips, max_diff = check_golden(img.cpu().numpy(),
                                       np.load(ROOT / "tests" / "golden" / f"{name}.npy"))
        out[name] = {"pixels_off": flips, "max_abs_diff": max_diff}
    for rough, img in caustic.items():
        if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0.01:
            raise AssertionError(f"caustic_box rough={rough}: mean {float(img.mean())}")
    require_b1("golden_materials", launches, plain)
    checked = check_kept(bk, kept)
    say("golden_materials", **out,
        caustic_box_mean={f"rough={r}": round(float(im.mean()), 6) for r, im in caustic.items()},
        b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0)


def timed(fn, dev):
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def render_cell(name, scene, cam, cfg, lanes, dev):
    """One full-size render through the wavefront, counted: render_s,
    useful rays/s (path.li_with_stats on 8 spp of every pixel), B1's
    launches (zeroed just before the render, read just after; the first
    launch per entry and batch size rerun through the twin), and the
    device busy share of a profiled 4-spp render. Returns (image, the
    render's B1 launches)."""
    import dataclasses

    from mitsuba_tpu_torch.integrators import wavefront
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    keeping, read = counted()
    with keeping:
        img, render_s = timed(lambda: wavefront.render(scene, cam, cfg, lanes_per_pixel=lanes), dev)
    launches, plain, kept = read()
    require_b1(f"{name} render", launches, plain)
    checked = check_kept(bk, kept)
    rays_per_sample = useful_rays_per_sample(scene, cam, cfg, count_spp=8)
    useful = rays_per_sample * cam.width * cam.height * cfg.spp
    say(name, resolution=f"{cam.width}x{cam.height}", spp=cfg.spp, max_depth=cfg.max_depth,
        lanes=lanes, tris=scene.num_triangles, render_s=round(render_s, 4),
        rays_per_sample=round(rays_per_sample, 4), useful_rays_per_s=round(useful / render_s),
        mean_radiance=round(float(img.mean()), 6), b1_launches=launches, b1_plain_calls=plain,
        twin_checked_rays=checked, twin_mismatches=0)
    phase_profile(name, scene, cam, dataclasses.replace(cfg, spp=4), lanes_per_pixel=lanes)
    return img, launches


def phase_veach(dev, lanes=4):
    """veach_mis at the builtin's 256x192, 64 spp, depth 3 (BASELINE's Veach
    MIS sweep) through the wavefront (render_cell); the image finite, the
    plate band lit (tests/test_baseline_configs.py:29). Then 64x48 x 16 spp
    through the wavefront and through common.render(path.li): equal within
    1e-5 (tests/test_wavefront.py:9). Returns B1's launches."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path, wavefront
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.veach_mis(device=dev)
    cfg = common.RenderConfig(spp=VEACH_SPP, max_depth=VEACH_DEPTH, seed=0)
    img, launches = render_cell("veach", scene, cam, cfg, lanes, dev)
    plates = float(img[cam.height * 14 // 36:cam.height * 26 // 36].mean())
    small, cam_s = builtin.veach_mis(64, 48, device=dev)
    cfg_s = common.RenderConfig(spp=16, max_depth=VEACH_DEPTH, seed=1)
    diff = float((wavefront.render(small, cam_s, cfg_s)
                  - common.render(small, cam_s, path.li, cfg_s)).abs().max())
    say("veach_check", plate_band_mean=round(plates, 6), wavefront_vs_path_max_abs_diff=diff)
    if not bool(torch.isfinite(img).all()) or tuple(img.shape) != (cam.height, cam.width, 3) \
            or not float(img.mean()) > 0.01 or not plates > 0.01 or not diff <= 1e-5:
        raise AssertionError(f"veach: mean {float(img.mean())}, plates {plates}, "
                             f"wavefront vs path {diff}")
    return launches


def phase_envmap_textured(dev, width=256, lanes=4):
    """The envmap_textured geometry at width x width, 64 spp, depth 3, with a
    1,024x1,024 texture and its mips (trilinear lookups, and EWA at the
    primary hit from the camera's ray differentials) under a 512x1,024
    envmap, both drawn with numpy from seed 0, through the wavefront
    (render_cell). Then tests/test_envmap.py:54's total-radiance protocol
    on that map (2^18 importance samples against the map's quadrature,
    2%). Returns B1's launches."""
    import torch

    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.scene import envmap

    rng = np.random.RandomState(0)
    tex = rng.uniform(0.2, 0.9, (1024, 1024, 3)).astype(np.float32)
    env = rng.uniform(0.0, 2.0, (512, 1024, 3)).astype(np.float32)
    scene, cam = textured_quad(dev, tex, env, width, width, mips=True)
    cfg = common.RenderConfig(spp=ENVMAP_SPP, max_depth=ENVMAP_DEPTH, seed=0)
    img, launches = render_cell("envmap_textured", scene, cam, cfg, lanes, dev)

    gen = torch.Generator(device=dev).manual_seed(3)
    _, pdf, rad = envmap.sample_direction(scene.envmap,
                                          torch.rand((1 << 18, 2), generator=gen, device=dev))
    est = (rad / pdf[:, None]).mean(0).cpu().numpy()
    h, w = env.shape[:2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    ref = (env * (np.sin(theta)[:, None, None] * (np.pi / h) * (2 * np.pi / w))).sum((0, 1))
    rel = float(np.abs(est / ref - 1.0).max())
    say("envmap_check", total_radiance=est.round(5).tolist(), quadrature=ref.round(5).tolist(),
        rel_err=round(rel, 6), bar=ENV_TOTAL_RTOL, mips_shape=list(scene.tex_mips.shape))
    if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0.01 \
            or not rel <= ENV_TOTAL_RTOL:
        raise AssertionError(f"envmap_textured: mean {float(img.mean())}, total radiance "
                             f"{est} against {ref}")
    return launches


def fd_step(loss, x, dev):
    """(value, gradient, forward s, backward s, peak GB, step peak GB) of
    loss(x) with x requiring grad. The peak counter is reset at the step's
    start: peak GB is the device's peak from there, what earlier phases
    still hold included; step peak GB is that peak less the memory
    allocated at the step's start, the step's own."""
    import torch

    x = x.detach().clone().requires_grad_(True)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    val, fwd_s = timed(lambda: loss(x), dev)
    _, bwd_s = timed(val.backward, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return float(val.detach()), x.grad, fwd_s, bwd_s, peak / 1e9, (peak - base) / 1e9


def phase_grad_materials(dev):
    """The gradients of this slice on the card, against central finite
    differences at their tests' bars. Roughness (tests/test_grad_coverage.py:60):
    the floor's alpha at 0.25, AD at 48 spp, FD at 192 spp, eps 0.05,
    within 15%. Texel (tests/test_baseline_configs.py:42): the envmap-lit
    textured quad (12x12, 16 spp, depth 2), texel [0, 3, 3, 1], eps 1e-2,
    within 5%. Forward and backward seconds, peak memory, the device time
    of torch's indexing backward in the texel step, B1's launches (first
    launch per entry and batch size rerun through the twin); every
    gradient finite. Returns B1's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    scene, cam = roughness_scene(dev)

    def rough_loss(spp):
        cfg = common.RenderConfig(spp=spp, max_depth=2, seed=7)

        def loss(alpha):
            tab = torch.cat([alpha.reshape(1, 1).expand(1, 2), scene.materials.alpha[1:]])
            s = scene.replace(materials=scene.materials.replace(alpha=tab))
            return common.render(s, cam, path.li, cfg).mean()
        return loss

    quad, qcam = textured_quad(dev, np.full((8, 8, 3), 0.5, np.float32),
                               np.ones((8, 16, 3), np.float32), 12, 12)
    qcfg = common.RenderConfig(spp=16, max_depth=2, seed=0)

    def texel_loss(texels):
        return common.render(quad.replace(textures=texels), qcam, path.li, qcfg).mean()

    keeping, read = counted()
    with keeping:
        _, g_r, fwd_r, bwd_r, peak_r, step_r = fd_step(rough_loss(48),
                                                       torch.tensor(0.25, device=dev), dev)
        _, g_t, fwd_t, bwd_t, peak_t, step_t = fd_step(texel_loss, quad.textures, dev)
    launches, plain, kept = read()
    checked = check_kept(bk, kept)
    with torch.no_grad():
        fd_r = (float(rough_loss(192)(torch.tensor(0.30, device=dev)))
                - float(rough_loss(192)(torch.tensor(0.20, device=dev)))) / 0.1
        e = torch.zeros_like(quad.textures)
        e[0, 3, 3, 1] = 1e-2
        fd_t = (float(texel_loss(quad.textures + e)) - float(texel_loss(quad.textures - e))) / 2e-2
    g_r, g_t3 = float(g_r), float(g_t[0, 3, 3, 1])
    # the texel step's backward under the profiler: torch's indexing backward
    x = quad.textures.detach().clone().requires_grad_(True)
    val = texel_loss(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        val.backward()
        torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [ev for ev in prof.key_averages() if ev.device_type == cuda]
    idx_ms = sum(ev.device_time_total for ev in kernels if "indexing_backward" in ev.key) / 1e3
    finite = bool(np.isfinite(g_r)) and bool(torch.isfinite(g_t).all())
    say("grad_materials", roughness_ad=round(g_r, 6), roughness_fd=round(fd_r, 6),
        roughness_rel_err=round(abs(g_r - fd_r) / abs(fd_r), 5), roughness_bar=ROUGH_FD_RTOL,
        texel_ad=round(g_t3, 6), texel_fd=round(fd_t, 6),
        texel_rel_err=round(abs(g_t3 - fd_t) / max(abs(fd_t), 1e-12), 5),
        texel_bar=TEXEL_FD_RTOL, texel_grad_abs_max=float(g_t.abs().max()),
        forward_s={"roughness": round(fwd_r, 4), "texel": round(fwd_t, 4)},
        backward_s={"roughness": round(bwd_r, 4), "texel": round(bwd_t, 4)},
        peak_gb={"roughness": round(peak_r, 4), "texel": round(peak_t, 4)},
        step_peak_gb={"roughness": round(step_r, 4), "texel": round(step_t, 4)},
        texel_backward_device_ms=round(sum(ev.device_time_total for ev in kernels) / 1e3, 4),
        indexing_backward_ms=round(idx_ms, 4), b1_launches=launches, b1_plain_calls=plain,
        twin_checked_rays=checked, twin_mismatches=0, finite=finite)
    require_b1("grad_materials", launches, plain)
    if not finite or not abs(fd_r) > 1e-6 \
            or abs(g_r - fd_r) > ROUGH_FD_RTOL * abs(fd_r) + 1e-5 \
            or abs(g_t3 - fd_t) > TEXEL_FD_RTOL * abs(fd_t) + 1e-5 \
            or not float(g_t.abs().max()) > 1e-5:
        raise AssertionError(f"material gradients: roughness {g_r} against FD {fd_r}, "
                             f"texel {g_t3} against FD {fd_t}, finite {finite}")
    return launches


# --- participating media and delta lights ----------------------------------

# The volpath_homogeneous golden's medium (tools/golden_scenes.py:32-37:
# sigma_s, sigma_a, g), also BASELINE's "homogeneous medium volpath" at the
# validation resolution (BASELINE.md:24-26): 256x256, 64 spp, depth 6.
FOG = ([0.2] * 3, [0.05] * 3, 0.3)
VOLPATH_SPP = 64
VOLPATH_DEPTH = 6
# a user's volume: a 128^3 float32 density grid (8 MB), the Gaussian blob of
# tests/test_volpath.py:215-220 at that resolution; 16 spp, depth 5
GRID_RES = 128
GRID_SPP = 8
GRID_DEPTH = 5
# tests/test_grad_coverage.py:26-57: AD 64 spp, FD 256 spp, eps 0.1, 12%
MEDIUM_FD_RTOL = 0.12
# the wavefront against path.li on a delta-lit scene, as veach_check
DELTA_CHECK_ATOL = 1e-5


def path_launches(path, launches, prefix="brute"):
    """{path: launches}, the kernels' names prefixed as in KERNELS."""
    return {path: {f"{prefix}_{k}": v for k, v in launches.items()}}


def fog(dev):
    from mitsuba_tpu_torch.models import medium

    return medium.make_homogeneous(*FOG, device=dev)


def blob_medium(cx, dev, res=GRID_RES):
    """tests/test_volpath.py:215-220's absorbing blob at x = cx over the unit
    box, on a res^3 grid."""
    from mitsuba_tpu_torch.models import medium

    zz, yy, xx = np.meshgrid(*([np.linspace(0, 1, res, dtype=np.float32)] * 3), indexing="ij")
    dens = np.exp(-((xx - cx) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2) / 0.02) * 4.0
    return medium.make_grid(dens.astype(np.float32), 6.0, 0.2, device=dev)


def li_cell(name, scene, cam, cfg, dev, li, scopes=None, profile=True, **fields):
    """One render through common.render(li), counted: render_s, samples/s,
    B1's launches (zeroed just before the render, read just after; the
    first launch per entry and batch size rerun through the twin), and,
    with `profile`, the device busy share and top kernels of a profiled
    4-spp render (phase_profile). `fields` join the printed line. Returns
    (image, B1's launches, the profile's scope shares, render_s)."""
    import dataclasses

    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    keeping, read = counted()
    with keeping:
        img, render_s = timed(lambda: common.render(scene, cam, li, cfg), dev)
    launches, plain, kept = read()
    require_b1(f"{name} render", launches, plain)
    checked = check_kept(bk, kept)
    say(name, resolution=f"{cam.width}x{cam.height}", spp=cfg.spp, max_depth=cfg.max_depth,
        tris=scene.num_triangles, **fields, render_s=round(render_s, 4),
        samples_per_s=round(cam.width * cam.height * cfg.spp / render_s),
        mean_radiance=round(float(img.mean()), 6), b1_launches=launches, b1_plain_calls=plain,
        twin_checked_rays=checked, twin_mismatches=0)
    shares = {}
    if profile:
        shares = phase_profile(name, scene, cam, dataclasses.replace(cfg, spp=4), li=li,
                               scopes=scopes)
    return img, launches, shares, render_s


def volpath_cell(name, scene, cam, cfg, dev, scopes=None):
    """li_cell through volpath.li. Returns (image, B1's launches, the
    profile's scope shares)."""
    from mitsuba_tpu_torch.integrators import volpath

    return li_cell(name, scene, cam, cfg, dev, volpath.li, scopes,
                   medium_kind=scene.medium.kind)[:3]


def require_finite(what, img, shape):
    import torch

    if not bool(torch.isfinite(img).all()) or tuple(img.shape) != shape:
        raise AssertionError(f"{what}: shape {tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")


def phase_golden_volpath(dev):
    """tools/golden_scenes.py's volpath_homogeneous (Cornell 24x24, 64 spp,
    depth 6, seed 7) through the port's volpath.li, against
    tests/golden/volpath_homogeneous.npy at the golden bar (check_golden).
    B1 carries every search; one launch per entry and batch size is rerun
    through its twin. Returns B1's launches as {path: launches}."""
    from mitsuba_tpu_torch.integrators import common, volpath
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(24, 24, device=dev)
    keeping, read = counted()
    with keeping:
        img = common.render(scene.replace(medium=fog(dev)), cam, volpath.li,
                            common.RenderConfig(spp=64, max_depth=6, seed=7))
    launches, plain, kept = read()
    require_b1("golden_volpath", launches, plain)
    checked = check_kept(bk, kept)
    flips, max_diff = check_golden(img.cpu().numpy(),
                                   np.load(ROOT / "tests" / "golden" / "volpath_homogeneous.npy"))
    say("golden_volpath", shape=list(img.shape), pixels_off=flips, max_abs_diff=max_diff,
        b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0)
    return path_launches("golden_volpath", launches)


def phase_volpath(dev, width=256):
    """BASELINE's homogeneous-medium volpath: the golden's medium in the
    Cornell box at width x width, VOLPATH_SPP spp, depth 6, through
    common.render(volpath.li) (volpath_cell; 8 chunks of 524,288 rays at
    256x256). The image finite and darker than the vacuum render of the
    same config (tests/test_volpath.py:107). Returns B1's launches as
    {path: launches}."""
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(width, width, device=dev)
    cfg = common.RenderConfig(spp=VOLPATH_SPP, max_depth=VOLPATH_DEPTH, seed=0)
    img, launches, _ = volpath_cell("volpath", scene.replace(medium=fog(dev)), cam, cfg, dev)
    vacuum, vacuum_s = timed(lambda: common.render(scene, cam, path.li, cfg), dev)
    mean, vac_mean = float(img.mean()), float(vacuum.mean())
    say("volpath_check", mean=round(mean, 6), vacuum_mean=round(vac_mean, 6),
        vacuum_render_s=round(vacuum_s, 4))
    require_finite("volpath image", img, (width, width, 3))
    if not 0.01 < mean < vac_mean:
        raise AssertionError(f"volpath: fog mean {mean} against vacuum {vac_mean}")
    return path_launches("volpath_render", launches)


def phase_volpath_grid(dev, width=256, res=GRID_RES):
    """A heterogeneous grid medium at a user's volume size: the absorbing
    blob on a res^3 grid (make_grid(dens, 6.0, 0.2) over the unit box) at
    x = 0.22 and at x = 0.78, width x width, depth 5. The first, at
    GRID_SPP spp, is counted and profiled (volpath_cell), with the share of
    device time inside medium.density_at (the tracking walks' trilinear
    gathers and their weights); the second, at 4 spp (one chunk), only
    serves the check that each blob darkens its own half of the image
    (tests/test_volpath.py:228-231). Returns B1's launches as {path:
    launches}."""
    import dataclasses

    from mitsuba_tpu_torch.integrators import common, volpath
    from mitsuba_tpu_torch.models import medium
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(width, width, device=dev)
    cfg = common.RenderConfig(spp=GRID_SPP, max_depth=GRID_DEPTH, seed=5)
    left, launches, shares = volpath_cell(
        "volpath_grid", scene.replace(medium=blob_medium(0.22, dev, res)), cam, cfg, dev,
        scopes={"density_at": (medium, "density_at")})
    right, right_s = timed(lambda: common.render(
        scene.replace(medium=blob_medium(0.78, dev, res)), cam, volpath.li,
        dataclasses.replace(cfg, spp=4)), dev)
    half = width // 2

    def ratio(img):
        return float(img[:, :half].mean()) / max(float(img[:, half:].mean()), 1e-6)

    lh, rh = ratio(left), ratio(right)
    diff = float((left - right).abs().max())
    say("volpath_grid_check", grid=[res] * 3, grid_mb=round(res ** 3 * 4 / 2 ** 20, 2),
        left_half_ratio=round(lh, 5), right_blob_half_ratio=round(rh, 5), max_abs_diff=diff,
        right_render_s=round(right_s, 4), density_share=shares["density_at"])
    for what, img in (("left blob", left), ("right blob", right)):
        require_finite(what, img, (width, width, 3))
    if not lh < rh or not diff > 0.01:
        raise AssertionError(f"volpath_grid: half ratios {lh} (left blob), {rh} (right), "
                             f"max diff {diff}")
    return path_launches("volpath_grid_render", launches)


def phase_volpath_delta(dev, width=256, small=(64, 48)):
    """Delta lights. cornell_box_lit("spot") inside the golden's fog, width x
    width, VOLPATH_SPP spp, depth 6, through volpath (volpath_cell): the
    beam lights the fog, so the upper centre of the image (seen through
    the cone) gains on its upper sides against the vacuum render.
    cornell_box_lit("point") through the wavefront at the same size
    (render_cell), and at `small` x 16 spp the wavefront against
    common.render(path.li) within DELTA_CHECK_ATOL. Returns B1's launches
    of the volumetric and the wavefront renders as {path: launches}."""
    from mitsuba_tpu_torch.integrators import common, path, wavefront
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box_lit("spot", width, width, device=dev)
    cfg = common.RenderConfig(spp=VOLPATH_SPP, max_depth=VOLPATH_DEPTH, seed=0)
    beam, launches, _ = volpath_cell("volpath_spot", scene.replace(medium=fog(dev)), cam, cfg, dev)
    vacuum = common.render(scene, cam, path.li, cfg)
    rows = slice(width // 8, width * 7 // 16)

    def centre_over_sides(img):
        return float(img[rows, width * 3 // 8:width * 5 // 8].mean()) / max(
            float(img[rows, width // 16:width * 3 // 16].mean()), 1e-6)

    fog_ratio, vac_ratio = centre_over_sides(beam), centre_over_sides(vacuum)
    point, cam_p = builtin.cornell_box_lit("point", width, width, device=dev)
    img_p, launches_p = render_cell("point_wavefront", point, cam_p, cfg, 4, dev)
    small_scene, cam_s = builtin.cornell_box_lit("point", *small, device=dev)
    cfg_s = common.RenderConfig(spp=16, max_depth=VOLPATH_DEPTH, seed=1)
    diff = float((wavefront.render(small_scene, cam_s, cfg_s)
                  - common.render(small_scene, cam_s, path.li, cfg_s)).abs().max())
    say("volpath_delta_check", beam_centre_over_sides=round(fog_ratio, 5),
        vacuum_centre_over_sides=round(vac_ratio, 5), spot_vacuum_mean=round(float(vacuum.mean()), 6),
        point_mean=round(float(img_p.mean()), 6), wavefront_vs_path_max_abs_diff=diff,
        bar=DELTA_CHECK_ATOL)
    require_finite("spot beam", beam, (width, width, 3))
    require_finite("point light", img_p, (width, width, 3))
    if not fog_ratio > vac_ratio or not float(img_p.mean()) > 0.01 \
            or not diff <= DELTA_CHECK_ATOL:
        raise AssertionError(f"volpath_delta: beam {fog_ratio} against vacuum {vac_ratio}, "
                             f"point mean {float(img_p.mean())}, wavefront vs path {diff}")
    return {**path_launches("volpath_spot_render", launches),
            **path_launches("point_wavefront_render", launches_p)}


def phase_volpath_mesh(dev, width=64):
    """sphere_shadow (10,372 triangles, BVH attached) in the golden's fog,
    width x width, 16 spp, depth 4, through volpath: every search on B2
    (its launches zeroed just before, read just after; none on B1), the
    first launch of each entry at each batch size rerun through the walk
    (check_kept); the image finite, lit and darker than the vacuum render.
    Returns B2's launches as {path: launches}."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path, volpath
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam, _ = builtin.sphere_shadow(width=width, height=width, attach_bvh=True, device=dev)
    cfg = common.RenderConfig(spp=16, max_depth=4, seed=0)
    for counts in (bk, bvk):
        counts.reset_counts()
    keeping, kept = keeping_launches(bvk)
    with keeping:
        img, render_s = timed(lambda: common.render(scene.replace(medium=fog(dev)), cam,
                                                    volpath.li, cfg), dev)
    launches, plain, brute = dict(bvk.KERNEL_LAUNCHES), dict(bvk.PLAIN_CALLS), dict(bk.KERNEL_LAUNCHES)
    checked = check_kept(bvk, kept)
    with torch.no_grad():
        vac_mean = float(common.render(scene, cam, path.li, cfg).mean())
    mean = float(img.mean())
    say("volpath_mesh", tris=scene.num_triangles, resolution=f"{width}x{width}", spp=cfg.spp,
        max_depth=cfg.max_depth, render_s=round(render_s, 4), mean_radiance=round(mean, 6),
        vacuum_mean=round(vac_mean, 6), bvh_kernel_launches=launches, bvh_plain_calls=plain,
        brute_launches=brute, twin_checked_rays=checked, twin_mismatches=0)
    require_finite("volpath_mesh image", img, (width, width, 3))
    if min(launches["closest"], launches["any_hit"]) == 0 or any(plain.values()) \
            or any(brute.values()):
        raise AssertionError(f"volpath_mesh bypassed B2: {launches}, plain {plain}, "
                             f"brute {brute}")
    if not 0.005 < mean < vac_mean:
        raise AssertionError(f"volpath_mesh: fog mean {mean} against vacuum {vac_mean}")
    return path_launches("volpath_mesh", launches, "bvh")


# the Cornell box's triangles: the back wall, and the short block's five faces
BACK_WALL_TRIS = slice(4, 6)
SHORT_BLOCK_TRIS = slice(10, 20)
WIRE_PARAMS = (0.15, 0.2, 0.75, 0.95, 0.9, 0.1, 0.06)


def vertex_color_cornell_args():
    """build_scene's arguments for a Cornell variant: the back wall a
    TEX_VERTEXCOLOR material with a colour per vertex from its position, the
    short block a TEX_WIREFRAME material (WIRE_PARAMS: interior rgb, edge
    rgb, line width). Numpy only, so the JAX package builds it too."""
    from mitsuba_tpu_torch.scene import builtin, ir

    scene, _ = builtin.cornell_box(8, 8, device="cpu")
    mats = [{"type": int(t), "reflectance": r.tolist()}
            for t, r in zip(scene.materials.type.numpy(), scene.materials.reflectance.numpy())]
    rad = scene.emitters.radiance.numpy()
    tri_rad = {t: rad[e].tolist() for t, e in enumerate(scene.tri_emitter.numpy()) if e >= 0}
    tri_mat = scene.tri_material.numpy().copy()
    tri_mat[BACK_WALL_TRIS] = len(mats)
    tri_mat[SHORT_BLOCK_TRIS] = len(mats) + 1
    mats += [{"type": ir.BSDF_DIFFUSE, "tex_reflectance": ir.TEX_VERTEXCOLOR},
             {"type": ir.BSDF_DIFFUSE, "tex_reflectance": ir.TEX_WIREFRAME}]
    verts = scene.vertices.numpy()
    colors = np.stack([verts[:, 0], verts[:, 1], 1.0 - verts[:, 0]], -1) * 0.8 + 0.1
    return dict(vertices=verts, indices=scene.indices.numpy(), tri_material=tri_mat,
                materials=mats, tri_radiance=tri_rad, vertex_colors=colors.astype(np.float32),
                wire_params=np.asarray(WIRE_PARAMS, np.float32))


def phase_grad_medium(dev):
    """tests/test_grad_coverage.py:26-57 on the card: d mean / d sigma_t of
    make_homogeneous(s/2, s/2) at s = 0.3 (seed 3) and d mean / d albedo of
    make_homogeneous(0.4 a, 0.4 (1 - a)) at a = 0.5 (seed 5), Cornell
    16x16, depth 3; AD at 64 spp against central FD at 256 spp, eps 0.1,
    within MEDIUM_FD_RTOL. Forward and backward seconds, peak_gb and
    step_peak_gb (fd_step), B1's launches with the twin reruns; every
    gradient finite. Returns B1's launches as {path: launches}."""
    import torch

    from mitsuba_tpu_torch.integrators import common, volpath
    from mitsuba_tpu_torch.models import medium
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(16, 16, device=dev)
    ones = torch.ones(3, device=dev)

    def loss_at(spp, seed, make):
        cfg = common.RenderConfig(spp=spp, max_depth=3, seed=seed)
        return lambda x: common.render(scene.replace(medium=make(x)), cam, volpath.li,
                                       cfg).mean()

    cases = {
        "sigma_t": (0.3, 3, lambda s: medium.make_homogeneous(ones * s * 0.5, ones * s * 0.5,
                                                              device=dev)),
        "albedo": (0.5, 5, lambda a: medium.make_homogeneous(a * 0.4, (1.0 - a) * 0.4,
                                                             device=dev)),
    }
    keeping, read = counted()
    steps = {}
    with keeping:
        for name, (x0, seed, make) in cases.items():
            steps[name] = fd_step(loss_at(64, seed, make), torch.tensor(x0, device=dev), dev)
    launches, plain, kept = read()
    checked = check_kept(bk, kept)
    out = {}
    for name, (x0, seed, make) in cases.items():
        with torch.no_grad():
            fd_loss = loss_at(256, seed, make)
            fd = (float(fd_loss(torch.tensor(x0 + 0.1, device=dev)))
                  - float(fd_loss(torch.tensor(x0 - 0.1, device=dev)))) / 0.2
        _, g, fwd_s, bwd_s, peak, step_peak = steps[name]
        out[name] = dict(ad=round(float(g), 6), fd=round(fd, 6),
                         rel_err=round(abs(float(g) - fd) / max(abs(fd), 1e-12), 5),
                         forward_s=round(fwd_s, 4), backward_s=round(bwd_s, 4),
                         peak_gb=round(peak, 4), step_peak_gb=round(step_peak, 4),
                         finite=bool(torch.isfinite(g).all()))
    say("grad_medium", **out, bar=MEDIUM_FD_RTOL, b1_launches=launches, b1_plain_calls=plain,
        twin_checked_rays=checked, twin_mismatches=0)
    require_b1("grad_medium", launches, plain)
    for name, r in out.items():
        if not r["finite"] or not abs(r["fd"]) > 1e-6 \
                or abs(r["ad"] - r["fd"]) > MEDIUM_FD_RTOL * abs(r["fd"]) + 1e-5:
            raise AssertionError(f"medium gradient {name}: AD {r['ad']} against FD {r['fd']}")
    return path_launches("grad_medium", launches)


# The render front end: the usual configuration of a user's scene (an LD
# sampler, hdrfilm's default Gaussian filter, a thin lens), every sampler,
# filter and sensor kind, the tiled film and the per-vertex textures.
FRONTEND_SPP = 64
FRONTEND_DEPTH = 8
FRONTEND_APERTURE = 0.03
FRONTEND_FOCUS = 1.9
# a filtered, thin-lens, LD render against the box, pinhole, independent
# one of the same scene and spp: the filters and the lens move no energy,
# the samplers are unbiased, so the means agree to the noise and the
# border's normalisation
FRONT_MEAN_RTOL = 0.02
# same-call (frontend, box) render pairs timed after the check: the host-
# bound render_s moves with host load, so one pair cannot set the ratio
FRONTEND_PAIRS = 3
# the per-kind renders: 128x128, 16 spp, depth 4 (one chunk)
SMALL, SMALL_SPP, SMALL_DEPTH = 128, 16, 4
SAMPLER_DIMS = (0, 1, 5, 63, 511, 1023, 2048, 4096)
SAMPLER_LANES = 1 << 20
SAMPLER_TIMED_LANES = 1 << 19
# tests/test_torch_samplers.py's bar: bit for bit where the code is integer
# arithmetic; else 1e-6, apart from lanes a rotation mod 1 wraps (1 in 10^4)
SAMPLER_ATOL = 1e-6
SAMPLER_MAX_WRAP_SHARE = 1e-4
SPLAT_RTOL, SPLAT_ATOL = 1e-5, 1e-6
# tests/test_sensors.py's meter bars, tests/test_motion.py:17-28's smear
METER_L = 0.8
MOTION_MEAN_RTOL, MOTION_GRADIENT_RATIO = 0.15, 0.9
WAVEFRONT_CHECK_ATOL = 1e-5
TILED_WIDTH, TILED_ROWS = 1024, 64
TILED_RTOL, TILED_ATOL = 1e-5, 1e-6
VCOLOR_MIN_REL_DIFF = 0.05


def thin_lens(cam):
    """`cam` as hdrfilm's usual thin lens: aperture 0.03, focused at 1.9."""
    import torch

    from mitsuba_tpu_torch.models import sensor

    dev = cam.to_world.device
    return cam.replace(kind=sensor.SENSOR_THINLENS,
                       aperture=torch.tensor(FRONTEND_APERTURE, device=dev),
                       focus_dist=torch.tensor(FRONTEND_FOCUS, device=dev))


def small_cornell(dev):
    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(SMALL, SMALL, device=dev)
    return scene, cam, common.RenderConfig(spp=SMALL_SPP, max_depth=SMALL_DEPTH, seed=0)


def phase_frontend(dev, width=256):
    """The slice at full width, as a user's scene names it: the Cornell box
    at width x width, FRONTEND_SPP spp, path at depth 8 through
    common.render, with the LD sampler, the Gaussian filter and a thin lens
    at the builtin pose (li_cell: render_s, samples/s, B1's launches from
    zero, twin reruns, busy share at 4 spp). The image finite, its mean
    within FRONT_MEAN_RTOL of the box, independent, pinhole render of the
    same scene and spp. Then FRONTEND_PAIRS more pairs of the two renders,
    in alternating order, give the front end's cost as the spread of
    render_s ratios. Returns B1's launches as {path: launches}."""
    import dataclasses

    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.samplers import qmc
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(width, width, device=dev)
    box = common.RenderConfig(spp=FRONTEND_SPP, max_depth=FRONTEND_DEPTH, rr_depth=5, seed=0)
    cfg = dataclasses.replace(box, sampler=qmc.SAMPLER_LD, filter=film.FILTER_GAUSSIAN)
    img, launches, _, _ = li_cell("frontend", scene, thin_lens(cam), cfg, dev, path.li,
                                  sampler="ld", filter="gaussian", sensor="thinlens")
    ref, ref_s = timed(lambda: common.render(scene, cam, path.li, box), dev)
    mean, ref_mean = float(img.mean()), float(ref.mean())
    say("frontend_check", mean=round(mean, 6), box_pinhole_independent_mean=round(ref_mean, 6),
        rel_diff=round(abs(mean - ref_mean) / ref_mean, 5), bar=FRONT_MEAN_RTOL,
        box_render_s=round(ref_s, 4))
    require_finite("frontend image", img, (width, width, 3))
    if abs(mean - ref_mean) > FRONT_MEAN_RTOL * ref_mean:
        raise AssertionError(f"frontend mean {mean} against {ref_mean}")
    lens = thin_lens(cam)
    renders = {"frontend": lambda: common.render(scene, lens, path.li, cfg),
               "box": lambda: common.render(scene, cam, path.li, box)}
    pairs = []
    for i in range(FRONTEND_PAIRS):
        order = ("frontend", "box") if i % 2 == 0 else ("box", "frontend")
        secs = {k: timed(renders[k], dev)[1] for k in order}
        pairs.append((secs["frontend"], secs["box"]))
    ratios = sorted(f / b for f, b in pairs)
    say("frontend_cost", pairs_render_s=[[round(f, 4), round(b, 4)] for f, b in pairs],
        frontend_over_box=[round(r, 4) for r in ratios])
    return path_launches("frontend_render", launches)


def phase_samplers(dev):
    """Every sampler kind: SAMPLER_LANES (pixel, sample) pairs at
    SAMPLER_DIMS on the card against the port's CPU values (bit for bit for
    independent, LD and Sobol'; else SAMPLER_ATOL with wrapped lanes
    counted); ms per dimension at SAMPLER_TIMED_LANES lanes, host included;
    tests/test_samplers.py:76-92 (direct.li at 16x16, 16 spp: LD closer to
    a 1,024-spp LD reference than independent); a 128x128 x 16 spp depth-4
    Cornell render per kind (li_cell), each mean but the stratified one's
    within FRONT_MEAN_RTOL of the independent one's. Returns B1's launches
    as {path: launches}."""
    import dataclasses

    import torch

    from mitsuba_tpu_torch.integrators import common, direct, path
    from mitsuba_tpu_torch.samplers import qmc
    from mitsuba_tpu_torch.scene import builtin

    rs = np.random.RandomState(0)
    idx = [torch.from_numpy(rs.randint(0, 2 ** 32, SAMPLER_LANES, dtype=np.uint64).astype(np.int64))
           for _ in range(2)]
    first = min(1 << 16, SAMPLER_LANES)
    idx[1][:first] = torch.arange(first)       # the sample indices a render uses
    on_card = [x.to(dev) for x in idx]
    parity, ms = {}, {}
    for kind, name in qmc.SAMPLER_NAMES.items():
        wraps, max_diff = 0, 0.0
        for dim in SAMPLER_DIMS:
            got = qmc.sample_dim(kind, 11, *on_card, dim, 64).cpu().numpy()
            want = qmc.sample_dim(kind, 11, *idx, dim, 64).numpy()
            if kind in (qmc.SAMPLER_INDEPENDENT, qmc.SAMPLER_LD, qmc.SAMPLER_SOBOL):
                if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                    raise AssertionError(f"sampler {name} dim {dim}: card differs from the CPU")
                continue
            diff = np.abs(got - want)
            wrap = (diff > 0.5) & (1.0 - diff <= SAMPLER_ATOL)
            wraps += int(wrap.sum())
            max_diff = max(max_diff, float(diff[~wrap].max()))
            if max_diff > SAMPLER_ATOL:
                raise AssertionError(f"sampler {name} dim {dim}: max diff {max_diff}")
        if wraps > SAMPLER_MAX_WRAP_SHARE * SAMPLER_LANES * len(SAMPLER_DIMS):
            raise AssertionError(f"sampler {name}: {wraps} wrapped lanes")
        parity[name] = {"max_abs_diff": max_diff, "wrapped_lanes": wraps}
        timed_idx = [x[:SAMPLER_TIMED_LANES] for x in on_card]
        qmc.sample_dim(kind, 11, *timed_idx, 3, 64)
        _, secs = timed(lambda: [qmc.sample_dim(kind, 11, *timed_idx, dim, 64)
                                 for _ in range(5) for dim in SAMPLER_DIMS], dev)
        ms[name] = round(secs * 1e3 / (5 * len(SAMPLER_DIMS)), 4)
    say("samplers", lanes=SAMPLER_LANES, dims=list(SAMPLER_DIMS), parity=parity,
        ms_per_dim_at=SAMPLER_TIMED_LANES, ms_per_dim=ms)

    scene16, cam16 = builtin.cornell_box(16, 16, device=dev)
    ref = common.render(scene16, cam16, direct.li, common.RenderConfig(
        spp=1024, max_depth=2, seed=100, sampler=qmc.SAMPLER_LD))
    errs = {}
    for kind in (qmc.SAMPLER_INDEPENDENT, qmc.SAMPLER_LD):
        img = common.render(scene16, cam16, direct.li, common.RenderConfig(
            spp=16, max_depth=2, seed=7, sampler=kind))
        errs[qmc.SAMPLER_NAMES[kind]] = float((img - ref).abs().mean())
    say("samplers_ld_check", mean_abs_err=errs)
    if not errs["ld"] < errs["independent"]:
        raise AssertionError(f"LD sampler not closer than independent: {errs}")

    scene, cam, cfg = small_cornell(dev)
    means, paths = {}, {}
    for kind, name in qmc.SAMPLER_NAMES.items():
        img, launches, _, _ = li_cell(f"sampler_{name}", scene, cam,
                                      dataclasses.replace(cfg, sampler=kind), dev,
                                      path.li, profile=False, sampler=name)
        paths.update(path_launches(f"sampler_{name}", launches))
        require_finite(f"sampler {name} image", img, (SMALL, SMALL, 3))
        means[name] = float(img.mean())
    rel = {k: round(v / means["independent"] - 1.0, 5) for k, v in means.items()}
    say("samplers_check", mean_rel_to_independent=rel, bar=FRONT_MEAN_RTOL)
    # the stratified sampler draws every dimension of sample i from stratum
    # i, so its dimensions correlate and the estimate is biased (ROADMAP
    # C29, the JAX package's semantics, kept for parity): printed, not held
    if any(abs(v) > FRONT_MEAN_RTOL for k, v in rel.items() if k != "stratified"):
        raise AssertionError(f"sampler means {means}")
    return paths


def phase_filters(dev):
    """Every reconstruction filter: a 128x128 x 16 spp depth-4 Cornell
    render (li_cell), finite, its mean within FRONT_MEAN_RTOL of the box
    render's; one splat of 524,288 fixed samples on the card against the
    same splat on the CPU (per pixel, SPLAT_RTOL / SPLAT_ATOL: atomic adds
    take another order), and its time. Returns B1's launches."""
    import dataclasses

    import torch

    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import path

    scene, cam, cfg = small_cornell(dev)
    means, paths, splats = {}, {}, {}
    rs = np.random.RandomState(1)
    n = 1 << 19
    pts = [torch.from_numpy(rs.uniform(-1, SMALL + 1, n).astype(np.float32)) for _ in range(2)]
    val = torch.from_numpy(rs.uniform(0, 2, (n, 3)).astype(np.float32))
    for kind, name in film.FILTER_NAMES.items():
        img, launches, _, _ = li_cell(f"filter_{name}", scene, cam,
                                      dataclasses.replace(cfg, filter=kind), dev,
                                      path.li, profile=False, filter=name)
        paths.update(path_launches(f"filter_{name}", launches))
        require_finite(f"filter {name} image", img, (SMALL, SMALL, 3))
        means[name] = float(img.mean())
        args = (SMALL, SMALL, *(p.to(dev) for p in pts), val.to(dev), kind)
        card = [x.cpu() for x in film.splat(*args)]
        cpu = film.splat(SMALL, SMALL, *pts, val, kind)
        for got, want in zip(card, cpu):
            torch.testing.assert_close(got, want, rtol=SPLAT_RTOL, atol=SPLAT_ATOL)
        _, secs = timed(lambda: [film.splat(*args) for _ in range(10)], dev)
        splats[name] = {"taps": film.support(kind) ** 2, "ms": round(secs * 100, 4),
                        "max_abs_diff": max(float((g - w).abs().max()) for g, w in zip(card, cpu))}
    say("filters_check", means={k: round(v, 6) for k, v in means.items()}, splat_samples=n,
        splat=splats)
    if any(abs(v - means["box"]) > FRONT_MEAN_RTOL * means["box"] for v in means.values()):
        raise AssertionError(f"filter means {means}")
    return paths


def phase_sensors(dev):
    """Every sensor kind and a motion-blurred pinhole: a 128x128 x 16 spp
    depth-4 Cornell render each (li_cell), finite. The three meters under a
    constant environment METER_L: L, 4 pi L, pi L at tests/test_sensors.py's
    bars; motion blur's smear (tests/test_motion.py:17-28); the wavefront
    with the thin lens against common.render(path.li) at 64x64 x 16 spp
    within WAVEFRONT_CHECK_ATOL. Returns B1's launches."""
    from mitsuba_tpu_torch.integrators import common, direct, path, wavefront
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.scene import builtin, ir

    scene, cam, cfg = small_cornell(dev)
    cams = {}
    for kind, name in sensor.SENSOR_NAMES.items():
        flat = kind in (sensor.SENSOR_ORTHOGRAPHIC, sensor.SENSOR_TELECENTRIC)
        cams[name] = sensor.make_camera([0.5, 0.5, -1.4], [0.5, 0.5, 0.0],
                                        fov_x=0.6 if flat else 39.3077, width=SMALL,
                                        height=SMALL, kind=kind, aperture=FRONTEND_APERTURE,
                                        focus_dist=FRONTEND_FOCUS, kc=(0.2, 0.0), device=dev)
    end = cam.to_world.clone()
    end[0, 3] += 0.3
    cams["perspective_motion"] = cam.replace(to_world_end=end)
    paths, means = {}, {}
    for name, c in cams.items():
        img, launches, _, _ = li_cell(f"sensor_{name}", scene, c, cfg, dev, path.li,
                                      profile=False, sensor=name)
        paths.update(path_launches(f"sensor_{name}", launches))
        require_finite(f"sensor {name} image", img, (SMALL, SMALL, 3))
        means[name] = round(float(img.mean()), 6)

    verts = np.asarray([[100, -100, 100], [101, -100, 100], [100, -100, 101]], np.float32)
    env = ir.build_scene(verts, np.asarray([[0, 1, 2]], np.int32), np.zeros(1, np.int32),
                         [{"type": ir.BSDF_DIFFUSE}], env_radiance=[METER_L] * 3, device=dev)
    meters = {}
    for kind, factor, spp, rtol in ((sensor.SENSOR_RADIANCEMETER, 1.0, 8, 1e-5),
                                    (sensor.SENSOR_FLUENCEMETER, 4 * np.pi, 512, 2e-2),
                                    (sensor.SENSOR_IRRADIANCEMETER, np.pi, 512, 2e-2)):
        mcam = sensor.make_camera([0, 0, 0], [0, 0, 1], width=1, height=1, kind=kind, device=dev)
        got = common.render(env, mcam, direct.li,
                            common.RenderConfig(spp=spp, max_depth=2, seed=0)).cpu().numpy()
        want = factor * METER_L
        meters[sensor.SENSOR_NAMES[kind]] = {"value": float(got.mean()), "expected": want}
        if not np.allclose(got, want, rtol=rtol, atol=1e-5 if rtol < 1e-4 else 0):
            raise AssertionError(f"meter {sensor.SENSOR_NAMES[kind]}: {got} against {want}")

    scene24, cam24 = builtin.cornell_box(24, 24, device=dev)
    end24 = cam24.to_world.clone()
    end24[0, 3] += 0.3
    cfg24 = common.RenderConfig(spp=64, max_depth=2, seed=0)
    static = common.render(scene24, cam24, path.li, cfg24).cpu().numpy()
    blurred = common.render(scene24, cam24.replace(to_world_end=end24), path.li,
                            cfg24).cpu().numpy()
    gx_s = float(np.abs(np.diff(static.mean(-1), axis=1)).mean())
    gx_b = float(np.abs(np.diff(blurred.mean(-1), axis=1)).mean())
    mean_shift = abs(float(blurred.mean()) - float(static.mean())) / float(static.mean())

    scene64, cam64 = builtin.cornell_box(64, 64, device=dev)
    lens64 = thin_lens(cam64)
    cfg64 = common.RenderConfig(spp=16, max_depth=SMALL_DEPTH, seed=1)
    diff = float((wavefront.render(scene64, lens64, cfg64)
                  - common.render(scene64, lens64, path.li, cfg64)).abs().max())
    say("sensors_check", means=means, meters=meters, motion_gradient_ratio=round(gx_b / gx_s, 5),
        motion_mean_shift=round(mean_shift, 5), thinlens_wavefront_vs_path_max_abs_diff=diff)
    if not np.isfinite(blurred).all() or mean_shift >= MOTION_MEAN_RTOL \
            or not gx_b < MOTION_GRADIENT_RATIO * gx_s:
        raise AssertionError(f"motion blur: gradient {gx_b} against {gx_s}, mean shift "
                             f"{mean_shift}")
    if not diff <= WAVEFRONT_CHECK_ATOL:
        raise AssertionError(f"thin-lens wavefront against path.li: {diff}")
    return paths


def phase_tiled(dev):
    """builtin.displaced_sphere (70,034 triangles, B2) on a TILED_WIDTH^2
    film, 16 spp, depth 4, through path.li: common.render's full frame and
    film.tiled.render_tiled in TILED_ROWS-row bands into a temporary EXR,
    read back (io.image.read_exr), equal within TILED_RTOL /
    TILED_ATOL (each band resolves its own chunk: another sum order). Each
    render's B2 launches from zero (none on B1, no plain walk), render_s,
    the device peak GB from its start (peak_gb) and that peak less what was
    allocated at its start (own_peak_gb: the render's own). Returns B2's
    launches."""
    import tempfile

    import torch

    from mitsuba_tpu_torch.film import tiled
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.displaced_sphere(width=TILED_WIDTH, height=TILED_WIDTH, device=dev)
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)

    def counted_run(fn):
        for counts in (bk, bvk):
            counts.reset_counts()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base_gb = torch.cuda.memory_allocated(dev) / 1e9
        out, secs = timed(fn, dev)
        launches, plain, brute = (dict(bvk.KERNEL_LAUNCHES), dict(bvk.PLAIN_CALLS),
                                  dict(bk.KERNEL_LAUNCHES))
        if min(launches["closest"], launches["any_hit"]) == 0 or any(plain.values()) \
                or any(brute.values()):
            raise AssertionError(f"tiled: B2 bypassed: {launches}, plain {plain}, "
                                 f"brute {brute}")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        return out, secs, launches, (round(peak_gb, 3), round(peak_gb - base_gb, 3))

    full, full_s, full_launches, full_gb = counted_run(
        lambda: common.render(scene, cam, path.li, cfg))
    full = full.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        exr = Path(tmp) / "tiled.exr"
        mean, tiled_s, launches, tiled_gb = counted_run(
            lambda: tiled.render_tiled(scene, cam, path.li, cfg, str(exr), tile_rows=TILED_ROWS))
        img = image.read_exr(exr)
    diff = np.abs(img - full)
    say("tiled", tris=scene.num_triangles, resolution=f"{TILED_WIDTH}x{TILED_WIDTH}",
        spp=cfg.spp, max_depth=cfg.max_depth, band_rows=TILED_ROWS,
        full_render_s=round(full_s, 4), tiled_render_s=round(tiled_s, 4),
        full_peak_gb=full_gb[0], full_own_peak_gb=full_gb[1], tiled_peak_gb=tiled_gb[0],
        tiled_own_peak_gb=tiled_gb[1],
        full_bvh_launches=full_launches, tiled_bvh_launches=launches,
        mean_radiance=round(float(full.mean()), 8), tiled_mean=round(mean, 8),
        max_abs_diff=float(diff.max()))
    if not np.isfinite(img).all() or not np.allclose(img, full, rtol=TILED_RTOL,
                                                     atol=TILED_ATOL):
        raise AssertionError(f"tiled film against the full frame: max diff {diff.max()}")
    return {**path_launches("tiled_full_frame", full_launches, "bvh"),
            **path_launches("tiled_render", launches, "bvh")}


def phase_vertex_colors(dev):
    """vertex_color_cornell_args's Cornell variant (vertex colours on the
    back wall, a wireframe material on the short block) at 128x128 x 16 spp,
    depth 4 (li_cell), finite; the back wall's pixels (primary hits on its
    two triangles) differ in mean from the flat Cornell render's by more
    than VCOLOR_MIN_REL_DIFF. Returns B1's launches."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.ops import trace
    from mitsuba_tpu_torch.scene import ir

    flat_scene, cam, cfg = small_cornell(dev)
    scene = ir.build_scene(**vertex_color_cornell_args(), device=dev)
    img, launches, _, _ = li_cell("vertex_colors", scene, cam, cfg, dev, path.li, profile=False)
    flat = common.render(flat_scene, cam, path.li, cfg)
    pix = torch.arange(SMALL * SMALL, device=dev)
    o, d, _ = sensor.sample_rays(cam, (pix % SMALL).float() + 0.5, (pix // SMALL).float() + 0.5,
                                 torch.zeros((pix.shape[0], 2), device=dev))
    prim = trace.closest_hit(scene, o, d).prim.view(SMALL, SMALL)
    wall = (prim >= BACK_WALL_TRIS.start) & (prim < BACK_WALL_TRIS.stop)
    block = (prim >= SHORT_BLOCK_TRIS.start) & (prim < SHORT_BLOCK_TRIS.stop)
    means = {what: [round(float(im[mask].mean()), 6) for im in (img, flat)]
             for what, mask in (("back_wall", wall), ("short_block", block))}
    rel = abs(means["back_wall"][0] - means["back_wall"][1]) / means["back_wall"][1]
    say("vertex_colors_check", wall_pixels=int(wall.sum()), block_pixels=int(block.sum()),
        coloured_vs_flat_means=means, back_wall_rel_diff=round(rel, 5))
    require_finite("vertex-colour image", img, (SMALL, SMALL, 3))
    if not rel > VCOLOR_MIN_REL_DIFF or int(wall.sum()) < 100:
        raise AssertionError(f"vertex colours: back wall {means['back_wall']}")
    return path_launches("vertex_colors", launches)


# The user's entry point: `python -m mitsuba_tpu_torch scene.xml -o out.exr`
# on scene files written from the builtin fixtures, one OBJ per run of
# triangles with one material and emitter. [cli_cornell] is [frontend]'s
# configuration (B1), [cli_mesh] the big mesh's (B2, the BVH attached by the
# CLI above trace.BRUTE_MAX_TRIS triangles), [cli_tiled] the same file with
# -D film=tiledhdrfilm -D res=1024.
CORNELL_LOOKAT = ("0.5, 0.5, -1.4", "0.5, 0.5, 0.0", "0, 1, 0")
CORNELL_FOV = "39.3077"
CLI_CORNELL_WIDTH, CLI_MESH_WIDTH, CLI_TILED_WIDTH = 256, 128, 1024
CLI_TIMEOUT_S = 300


def obj_groups(vertices, indices, tri_material, tri_emitter, radiance):
    """Runs of consecutive triangles sharing a material and an emitter, each
    as (material, radiance or None, its vertices in first-use order, its
    indices into them): save_obj writes them and load_obj reads the same
    arrays back."""
    key = np.stack([tri_material, tri_emitter], 1)
    cuts = np.flatnonzero((key[1:] != key[:-1]).any(1)) + 1
    groups = []
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(indices)]):
        tris = indices[lo:hi]
        first = np.unique(tris.ravel(), return_index=True)[1]
        used = tris.ravel()[np.sort(first)]
        remap = np.full(vertices.shape[0], -1, np.int64)
        remap[used] = np.arange(len(used))
        e = int(tri_emitter[lo])
        groups.append((int(tri_material[lo]), None if e < 0 else radiance[e],
                       vertices[used], remap[tris].astype(np.int32)))
    return groups


def _csv(v):
    return ", ".join(repr(float(x)) for x in np.asarray(v, np.float32).ravel())


def write_scene_files(d, scene, sensor_xml, integrator_xml):
    """`scene` (a port Scene of diffuse materials) as OBJ files and one
    scene.xml in `d`. Returns (the XML's path, the groups written)."""
    from mitsuba_tpu_torch.io import mesh

    def host(x):
        return x.detach().cpu().numpy()

    groups = obj_groups(host(scene.vertices), host(scene.indices), host(scene.tri_material),
                        host(scene.tri_emitter), host(scene.emitters.radiance))
    refl = host(scene.materials.reflectance)
    parts = ['<scene version="0.6.0">', '<default name="film" value="hdrfilm"/>',
             integrator_xml, sensor_xml]
    parts += [f'<bsdf type="diffuse" id="m{i}"><rgb name="reflectance" value="{_csv(r)}"/></bsdf>'
              for i, r in enumerate(refl)]
    for g, (mat, rad, verts, tris) in enumerate(groups):
        mesh.save_obj(Path(d) / f"g{g:02d}.obj", verts, tris)
        emitter = ("" if rad is None else
                   f'<emitter type="area"><rgb name="radiance" value="{_csv(rad)}"/></emitter>')
        parts.append(f'<shape type="obj"><string name="filename" value="g{g:02d}.obj"/>'
                     f'<ref id="m{mat}"/>{emitter}</shape>')
    xml_path = Path(d) / "scene.xml"
    xml_path.write_text("\n".join(parts + ["</scene>"]) + "\n")
    return xml_path, groups


def check_loaded(what, xml_path, groups, scene, cam, dev, defaults=None):
    """The scene file loaded in process: its vertices and indices equal the
    groups' (offset, concatenated) bit for bit, its triangles' corners and
    its camera pose the fixture's. Returns the triangle count."""
    import torch

    from mitsuba_tpu_torch.scene import xml

    loaded, lcam, _, _ = xml.load_xml(xml_path, defaults=defaults, device=dev)
    verts = np.concatenate([g[2] for g in groups])
    offs = np.cumsum([0] + [len(g[2]) for g in groups[:-1]])
    tris = np.concatenate([g[3] + o for g, o in zip(groups, offs)])
    got_v, got_i = loaded.vertices.cpu().numpy(), loaded.indices.cpu().numpy()
    corners = (loaded.vertices[loaded.indices.long()] == scene.vertices[scene.indices.long()])
    if not (np.array_equal(got_v, verts) and np.array_equal(got_i, tris)
            and bool(corners.all()) and torch.equal(lcam.to_world, cam.to_world)):
        raise AssertionError(f"{what}: the loaded arrays differ from the fixture's")
    return loaded.num_triangles


def run_cli_subprocess(xml_path, out, extra=()):
    """The real command, `python -m mitsuba_tpu_torch <xml> -o <out>`, from
    the checkout's root. Returns its wall seconds (CUDA start-up and
    loading the built kernels included); raises on a non-zero exit."""
    import os

    cmd = [sys.executable, "-m", "mitsuba_tpu_torch", str(xml_path), "-o", str(out), "-q",
           *extra]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return wall


def run_cli_counted(mod, argv, dev):
    """cli.main(argv) in process with `mod`'s launches counted from zero
    and the first launch per entry and batch size rerun through the plain
    twin (check_kept). Returns (launches, twin-checked batch sizes, the
    run's Time.load / Time.bvh / Time.render seconds)."""
    import torch

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.utils import stats

    stats.get_statistics().reset()
    for counts in (bk, bvk):
        counts.reset_counts()
    keeping, kept = keeping_launches(mod)
    with keeping:
        code = cli.main([str(a) for a in argv] + ["-q"])
    torch.cuda.synchronize(dev)
    launches, plain = dict(mod.KERNEL_LAUNCHES), {**bk.PLAIN_CALLS, **bvk.PLAIN_CALLS}
    other = bvk if mod is bk else bk
    if code != 0 or min(launches["closest"], launches["any_hit"]) == 0 or any(plain.values()) \
            or any(other.KERNEL_LAUNCHES.values()):
        raise AssertionError(f"cli {argv}: exit {code}, launches {launches}, plain calls "
                             f"{plain}, other kernel {other.KERNEL_LAUNCHES}")
    checked = check_kept(mod, kept)
    st = stats.get_statistics()
    times = {f"{k}_s": round(st.counter(f"Time.{k}").value, 4) for k in ("load", "bvh", "render")}
    return launches, checked, times


def cli_cornell_files(tmp, dev):
    """[frontend]'s configuration as a user's scene files in `tmp`:
    builtin.cornell_box as one OBJ per material run, `ldsampler` at
    FRONTEND_SPP, hdrfilm with a Gaussian rfilter, a thin lens (aperture
    0.03, focus 1.9), CLI_CORNELL_WIDTH^2, path at depth 8. Returns (the
    XML's path, the OBJ groups, the builtin scene and pinhole camera, the
    config the file names)."""
    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.samplers import qmc
    from mitsuba_tpu_torch.scene import builtin

    width, spp = CLI_CORNELL_WIDTH, FRONTEND_SPP
    scene, cam = builtin.cornell_box(width, width, device=dev)
    cfg = common.RenderConfig(spp=spp, max_depth=FRONTEND_DEPTH, rr_depth=5, seed=0,
                              sampler=qmc.SAMPLER_LD, filter=film.FILTER_GAUSSIAN)
    origin, target, up = CORNELL_LOOKAT
    sensor_xml = (f'<sensor type="thinlens"><float name="fov" value="{CORNELL_FOV}"/>'
                  f'<float name="apertureRadius" value="{FRONTEND_APERTURE}"/>'
                  f'<float name="focusDistance" value="{FRONTEND_FOCUS}"/>'
                  f'<transform name="toWorld"><lookat origin="{origin}" target="{target}" '
                  f'up="{up}"/></transform><sampler type="ldsampler"><integer '
                  f'name="sampleCount" value="{spp}"/></sampler><film type="$film">'
                  f'<integer name="width" value="{width}"/><integer name="height" '
                  f'value="{width}"/><rfilter type="gaussian"/></film></sensor>')
    integrator_xml = (f'<integrator type="path"><integer name="maxDepth" '
                      f'value="{FRONTEND_DEPTH}"/></integrator>')
    xml_path, groups = write_scene_files(tmp, scene, sensor_xml, integrator_xml)
    return xml_path, groups, scene, cam, cfg


def phase_cli_cornell(dev):
    """[frontend]'s configuration as a user's scene file: builtin.cornell_box
    written as one OBJ per material run, `ldsampler` at FRONTEND_SPP,
    hdrfilm with a Gaussian rfilter, a thin lens (aperture 0.03, focus 1.9),
    CLI_CORNELL_WIDTH^2, path at depth 8. The real command renders it (exit code checked, wall time);
    cli.main renders it in process with B1's launches counted and twin
    checked; the loaded arrays equal the fixture's bit for bit; both EXRs
    equal the in-process render of the builtin scene at the goldens' bar
    (check_golden), and the eager render of the loaded scene at C31's bar
    (the CLI renders through common.render_jit); the device busy share of a 4-spp render of the loaded
    scene (phase_profile). Returns B1's launches as {path: launches}."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import xml

    width, spp = CLI_CORNELL_WIDTH, FRONTEND_SPP
    with tempfile.TemporaryDirectory() as tmp:
        xml_path, groups, scene, cam, cfg = cli_cornell_files(tmp, dev)
        ref = common.render(scene, thin_lens(cam), path.li, cfg).cpu().numpy()
        tris = check_loaded("cli_cornell", xml_path, groups, scene, cam, dev)
        wall = run_cli_subprocess(xml_path, Path(tmp) / "sub.exr")
        launches, checked, times = run_cli_counted(bk, [xml_path, "-o", Path(tmp) / "in.exr"], dev)
        sub, inproc = (image.read_exr(Path(tmp) / name) for name in ("sub.exr", "in.exr"))
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
    if lcfg != cfg:
        raise AssertionError(f"cli_cornell: loaded config {lcfg} against {cfg}")
    (flips, max_diff), (flips_in, max_diff_in) = check_golden(sub, ref), check_golden(inproc, ref)
    # the CLI renders through common.render_jit: its images against the
    # eager render of the loaded scene, at C31's bar (the splat's atomics)
    eager = common.render(loaded, lcam, path.li, lcfg).cpu().numpy()
    jit_diff = [float(np.abs(im - eager).max()) for im in (sub, inproc)]
    if not all(np.allclose(im, eager, rtol=JIT_RTOL, atol=JIT_ATOL) for im in (sub, inproc)):
        raise AssertionError(f"cli_cornell: the CLI's images {jit_diff} off the eager render "
                             f"of the loaded scene (C31: rtol {JIT_RTOL}, atol {JIT_ATOL})")
    say("cli_cornell", resolution=f"{width}x{width}", spp=spp, tris=tris, obj_files=len(groups),
        subprocess_wall_s=round(wall, 3), **times, b1_launches=launches,
        twin_checked_rays=checked, twin_mismatches=0, pixels_off=[flips, flips_in],
        max_abs_diff=[max_diff, max_diff_in], eager_max_abs_diff=jit_diff,
        mean_radiance=round(float(inproc.mean()), 6))
    phase_profile("cli_cornell", loaded, lcam, dataclasses.replace(lcfg, spp=4), li=path.li)
    return path_launches("cli_cornell", launches)


def phase_cli_mesh(dev):
    """builtin.displaced_sphere_mesh (70,034 triangles) as OBJ files under
    bench.py's big-mesh configuration: CLI_MESH_WIDTH^2, 16 spp (independent),
    hdrfilm (box), path at depth 4, rr 3. [cli_mesh]: the real command and
    cli.main (B2's launches counted and twin checked; the CLI attaches the
    BVH), the loaded arrays equal the fixture's, both images equal
    common.render of builtin.displaced_sphere at the goldens' bar.
    [cli_tiled]: the same file with -D film=tiledhdrfilm -D res=CLI_TILED_WIDTH,
    by the real command and by cli.main, against the full-frame cli.main
    render at C32's bar. Returns B2's launches of both as {path: launches}."""
    import tempfile

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    width, tiled_width = CLI_MESH_WIDTH, CLI_TILED_WIDTH
    scene, cam = builtin.displaced_sphere(width=width, height=width, device=dev)
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
    ref = common.render(scene, cam, path.li, cfg).cpu().numpy()
    view = builtin.DISPLACED_SPHERE_CAMERA
    sensor_xml = (f'<default name="res" value="{width}"/><sensor type="perspective">'
                  f'<float name="fov" value="{view["fov_x"]}"/><transform name="toWorld">'
                  f'<lookat origin="{_csv(view["origin"])}" target="{_csv(view["target"])}" '
                  f'up="0, 1, 0"/></transform><sampler type="independent"><integer '
                  f'name="sampleCount" value="16"/></sampler><film type="$film"><integer '
                  f'name="width" value="$res"/><integer name="height" value="$res"/></film>'
                  f'</sensor>')
    integrator_xml = ('<integrator type="path"><integer name="maxDepth" value="4"/>'
                      '<integer name="rrDepth" value="3"/></integrator>')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path, groups = write_scene_files(tmp, scene, sensor_xml, integrator_xml)
        tris = check_loaded("cli_mesh", xml_path, groups, scene, cam, dev)
        wall = run_cli_subprocess(xml_path, tmp / "sub.exr")
        launches, checked, times = run_cli_counted(bvk, [xml_path, "-o", tmp / "in.exr"], dev)
        sub, inproc = image.read_exr(tmp / "sub.exr"), image.read_exr(tmp / "in.exr")
        (flips, max_diff), (flips_in, max_diff_in) = check_golden(sub, ref), \
            check_golden(inproc, ref)
        say("cli_mesh", resolution=f"{width}x{width}", spp=cfg.spp, tris=tris,
            obj_files=len(groups), subprocess_wall_s=round(wall, 3), **times,
            bvh_launches=launches, twin_checked_rays=checked, twin_mismatches=0,
            pixels_off=[flips, flips_in], max_abs_diff=[max_diff, max_diff_in],
            mean_radiance=round(float(inproc.mean()), 8))
        out.update(path_launches("cli_mesh", launches, "bvh"))

        big = ["-D", f"res={tiled_width}"]
        tiled_args = ["-D", "film=tiledhdrfilm", *big]
        _, _, full_times = run_cli_counted(bvk, [xml_path, "-o", tmp / "full.exr", *big], dev)
        wall = run_cli_subprocess(xml_path, tmp / "sub_tiled.exr", tiled_args)
        launches, checked, times = run_cli_counted(
            bvk, [xml_path, "-o", tmp / "tiled.exr", *tiled_args], dev)
        full = image.read_exr(tmp / "full.exr")
        diffs = []
        for name in ("sub_tiled.exr", "tiled.exr"):
            img = image.read_exr(tmp / name)
            diffs.append(float(np.abs(img - full).max()))
            if img.shape != full.shape or not np.allclose(img, full, rtol=TILED_RTOL,
                                                          atol=TILED_ATOL):
                raise AssertionError(f"cli_tiled {name} against the full frame: max diff "
                                     f"{diffs[-1]}")
        say("cli_tiled", resolution=f"{tiled_width}x{tiled_width}", spp=cfg.spp,
            subprocess_wall_s=round(wall, 3), **times,
            full_frame_render_s=full_times["render_s"], bvh_launches=launches,
            twin_checked_rays=checked, twin_mismatches=0, max_abs_diff=diffs)
        out.update(path_launches("cli_tiled", launches, "bvh"))
    return out


# --- the bidirectional family -------------------------------------------------

BIDIR_WIDTH, BIDIR_SMALL = 256, 128
BIDIR_SPP = 16
BIDIR_DEPTH = 8
BIDIR_REF_SPP = 64
BIDIR_PROFILE_SPP = 4
AOV_SPP = 4
CLI_BIDIR_SPP = 16          # -s 16 on [cli_cornell]'s 64-spp files
# the JAX tests' bars on |mean - path's mean| / path's mean
BDPT_RTOL = 0.05            # tests/test_bdpt.py:20
LIGHT_IMAGE_RTOL = 0.06     # tests/test_bdpt.py:57
CAUSTIC_RTOL = 0.12         # tests/test_bdpt.py:71
LVCBPT_RTOL = 0.08          # tests/test_lvcbpt.py:17, :43, :53
PTRACER_RTOL = 0.10         # tests/test_ptracer.py:20
OCCUPANCY_RTOL = 0.15       # tests/test_occupancy.py:42
MULTICHANNEL_TOL = 1e-4
MARCH_LANES = 1 << 19
# the light image's splat (bdpt.splat_to_film) on the card against the CPU
SPLAT_SAMPLES = 1 << 19
# the camera's shutter-close pose for [aov]'s motion vectors: 0.05 along x
MOTION_SHIFT = 0.05


def _bidir_cfg(spp=None, depth=None, **changes):
    """The group's RenderConfig: BIDIR_SPP and BIDIR_DEPTH unless given,
    rr 5, seed 0."""
    from mitsuba_tpu_torch.integrators import common

    return common.RenderConfig(spp=spp or BIDIR_SPP, max_depth=depth or BIDIR_DEPTH,
                               rr_depth=5, seed=0, **changes)


def path_mean(scene, cam, depth, dev):
    """The mean of path.li's render of the same scene at BIDIR_REF_SPP
    (seed 0): the reference of the bidirectional mean checks."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path

    with torch.no_grad():
        return float(common.render(scene, cam, path.li,
                                   _bidir_cfg(BIDIR_REF_SPP, depth)).mean())


def bidir_cell(name, make, cfg, dev, scene, cam, ref=None, rtol=None, kernel="b1",
               need=("closest", "any_hit"), samples=None, scopes=None, **fields):
    """make(cfg) counted: render_s, samples/s (pixels x spp, or `samples`,
    a count or a function called after the render that gives it),
    step_peak_gb (the device's peak from the render's start less what was
    allocated there), the kernel's launches (zeroed just before, read just
    after; every entry in `need` launched, the other kernel and the plain
    twins never) with the first launch per entry and batch size rerun
    through the twin (check_kept); the image finite, and its mean within
    `rtol` of `ref` where given. Then the device busy share of make() at
    BIDIR_PROFILE_SPP (profile_call, with its `scopes`). Keeps (image, cfg,
    launches, render_s) in EAGER_CELLS[name]. Returns (image, {path:
    launches})."""
    import dataclasses

    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk

    mod, other = (bvk, bk) if kernel == "b2" else (bk, bvk)
    for counts in (bk, bvk):
        counts.reset_counts()
    keeping, kept = keeping_launches(mod)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with keeping:
        img, render_s = timed(lambda: make(cfg), dev)
    step_peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    launches = dict(mod.KERNEL_LAUNCHES)
    plain = {**bk.PLAIN_CALLS, **bvk.PLAIN_CALLS}
    others = dict(other.KERNEL_LAUNCHES)
    twin_entry = {"closest": "closest_key", "any_hit": "blocked" if mod is bvk else "any_hit"}
    checked = check_kept(mod, kept, entries=[twin_entry[k] for k in need])
    del kept
    mean = float(img.mean())
    n = (samples() if callable(samples) else samples) or cam.width * cam.height * cfg.spp
    line = dict(resolution=f"{cam.width}x{cam.height}", spp=cfg.spp, max_depth=cfg.max_depth,
                tris=scene.num_triangles, **fields, render_s=round(render_s, 4),
                samples_per_s=round(n / render_s), step_peak_gb=round(step_peak_gb, 3),
                mean_radiance=round(mean, 6))
    if ref is not None:
        line.update(path_mean=round(ref, 6), rel_to_path=round(abs(mean - ref) / ref, 5),
                    bar=rtol)
    say(name, **line, **{f"{kernel}_launches": launches}, plain_calls=plain,
        other_kernel_launches=others, twin_checked_rays=checked, twin_mismatches=0)
    require_finite(name, img, tuple(img.shape))
    if min(launches[k] for k in need) == 0 or any(plain.values()) or any(others.values()):
        raise AssertionError(f"{name} bypassed {kernel}: launches {launches}, plain calls "
                             f"{plain}, other kernel {others}")
    if ref is not None and not abs(mean - ref) <= rtol * ref:
        raise AssertionError(f"{name}: mean {mean} against path's {ref}, bar {rtol}")
    prefix = "bvh" if kernel == "b2" else "brute"
    EAGER_CELLS[name] = (img, cfg, {f"{prefix}_{k}": v for k, v in launches.items()}, render_s)
    small = dataclasses.replace(cfg, spp=min(cfg.spp, BIDIR_PROFILE_SPP))
    profile_call(name, lambda: make(small), dev, scopes, resolution=f"{cam.width}x{cam.height}",
                 spp=small.spp)
    return img, path_launches(name, launches, "bvh" if kernel == "b2" else "brute")


def li_render(scene, cam, li):
    """make(cfg) of a bidir_cell: common.render with the integrator li."""
    from mitsuba_tpu_torch.integrators import common

    return lambda cfg: common.render(scene, cam, li, cfg)


def phase_bdpt(dev):
    """[bdpt]: bdpt.li through common.render on the Cornell box at 256x256 x
    16 spp, depth 8 (the headline's), its mean within 5% of path.li's
    (64 spp). [bdpt_light_image]: bdpt.render (the t=1 splats) with the
    same settings, within 6%; caustic_box at 128x128 x 16 spp, depth 4,
    within 12%. Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import bdpt
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    ref = path_mean(scene, cam, BIDIR_DEPTH, dev)
    out = {}
    for name, make, rtol in (("bdpt", li_render(scene, cam, bdpt.li), BDPT_RTOL),
                             ("bdpt_light_image", lambda cfg: bdpt.render(scene, cam, cfg),
                              LIGHT_IMAGE_RTOL)):
        out.update(bidir_cell(name, make, _bidir_cfg(), dev, scene, cam, ref, rtol)[1])
    scene, cam = builtin.caustic_box(BIDIR_SMALL, BIDIR_SMALL, device=dev)
    out.update(bidir_cell("bdpt_light_image_caustic", lambda cfg: bdpt.render(scene, cam, cfg),
                          _bidir_cfg(depth=4), dev, scene, cam, path_mean(scene, cam, 4, dev),
                          CAUSTIC_RTOL)[1])
    return out


def phase_lvcbpt(dev):
    """[lvcbpt]: lvcbpt.li on the Cornell box at 256x256 x 16 spp, depth 8,
    the power heuristic (mis_mode 0), within 8% of path.li; the balance and
    uniform modes at 128x128 x 16 spp, and cornell_box_lit("point") at
    128x128 x 16 spp, depth 3, each within 8%. Returns B1's launches by
    path."""
    from mitsuba_tpu_torch.integrators import lvcbpt
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    out = dict(bidir_cell("lvcbpt", li_render(scene, cam, lvcbpt.li), _bidir_cfg(mis_mode=0),
                          dev, scene, cam, path_mean(scene, cam, BIDIR_DEPTH, dev),
                          LVCBPT_RTOL, mis_mode=0)[1])
    scene, cam = builtin.cornell_box(BIDIR_SMALL, BIDIR_SMALL, device=dev)
    ref = path_mean(scene, cam, BIDIR_DEPTH, dev)
    for mode, label in ((1, "balance"), (2, "uniform")):
        out.update(bidir_cell(f"lvcbpt_{label}", li_render(scene, cam, lvcbpt.li),
                              _bidir_cfg(mis_mode=mode), dev, scene, cam, ref, LVCBPT_RTOL,
                              mis_mode=mode)[1])
    scene, cam = builtin.cornell_box_lit("point", BIDIR_SMALL, BIDIR_SMALL, device=dev)
    out.update(bidir_cell("lvcbpt_point", li_render(scene, cam, lvcbpt.li), _bidir_cfg(depth=3),
                          dev, scene, cam, path_mean(scene, cam, 3, dev), LVCBPT_RTOL)[1])
    return out


def phase_ptracer_vpl(dev):
    """[ptracer]: ptracer.render on the Cornell box at 256x256 x 16 spp,
    depth 8: 1,048,576 particles in 2 chunks of 2^19, within 10% of
    path.li. [vpl]: vpl.li at 256x256 x 16 spp, its mean beside path's (no
    bar: VPL clamps its geometry term, biased by design). [splat_check]:
    the light image's splat on the card against the CPU. Returns B1's
    launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import bdpt, ptracer, vpl
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    ref = path_mean(scene, cam, BIDIR_DEPTH, dev)
    cfg = _bidir_cfg()
    n = w * w * cfg.spp
    out = dict(bidir_cell("ptracer", lambda c: ptracer.render(scene, cam, c), cfg, dev, scene,
                          cam, ref, PTRACER_RTOL, particles=n,
                          chunks=-(-n // ptracer.CHUNK))[1])
    out.update(bidir_cell("vpl", li_render(scene, cam, vpl.li), cfg, dev, scene, cam,
                          path_mean_for_comparison=round(ref, 6))[1])

    # the splats of ptracer and bdpt.render: the same SPLAT_SAMPLES raster
    # positions and contributions on the card and on the CPU, per pixel at
    # C31's bar (the card adds in atomic order)
    rs = np.random.RandomState(2)
    px, py = (torch.from_numpy(rs.uniform(-1, w + 1, SPLAT_SAMPLES).astype(np.float32))
              for _ in range(2))
    val = torch.from_numpy(rs.uniform(0, 2, (SPLAT_SAMPLES, 3)).astype(np.float32))
    card = torch.zeros((w * w, 3), device=dev)
    bdpt.splat_to_film(card, cam, px.to(dev), py.to(dev), val.to(dev))
    cpu = torch.zeros((w * w, 3))
    bdpt.splat_to_film(cpu, cam, px, py, val)
    diff = float((card.cpu() - cpu).abs().max())
    say("splat_check", samples=SPLAT_SAMPLES, pixels=w * w, max_abs_diff=diff,
        bar=[SPLAT_RTOL, SPLAT_ATOL])
    torch.testing.assert_close(card.cpu(), cpu, rtol=SPLAT_RTOL, atol=SPLAT_ATOL)
    return out


def phase_occupancy(dev):
    """[occupancy]: the map built on the Cornell box (ops/occupancy.attach,
    res 128); path.li with occupancy_shadows at 256x256 x 64 spp, depth 8,
    within 15% of the exact render (every shadow ray marched: B1's any-hit
    never launched); the march's ms per shadow query at 2^19 lanes beside
    B1's any-hit on the same segments (call_ms, CUDA events) and their
    agreement; lvcbpt.li with the map (the fork's LVCBPT_OM) at 128x128 x
    16 spp, its mean beside the exact one. Returns B1's launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import common, lvcbpt, path
    from mitsuba_tpu_torch.ops import occupancy, trace
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    scene_om, build_s = timed(lambda: occupancy.attach(scene), dev)
    out = {}
    _, launches = bidir_cell("occupancy_path", li_render(scene_om, cam, path.li),
                             _bidir_cfg(BIDIR_REF_SPP, occupancy_shadows=True), dev, scene_om,
                             cam, path_mean(scene, cam, BIDIR_DEPTH, dev), OCCUPANCY_RTOL,
                             need=("closest",), build_s=round(build_s, 4),
                             occupied_voxels=int(scene_om.occupancy.grid.sum()))
    if launches["occupancy_path"]["brute_any_hit"]:
        raise AssertionError(f"occupancy_path: shadow rays took B1: {launches}")
    out.update(launches)

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((MARCH_LANES, 3), generator=gen, device=dev) * 0.9 + 0.05
    b = torch.rand((MARCH_LANES, 3), generator=gen, device=dev) * 0.9 + 0.05
    dist = torch.linalg.norm(b - a, dim=1)
    d = (b - a) / dist[:, None]
    march_ms = call_ms(lambda: occupancy.occluded(scene_om.occupancy, a, d, dist), dev)
    any_hit_ms = call_ms(lambda: trace.any_hit(scene, a, d, dist), dev)
    agree = float((occupancy.occluded(scene_om.occupancy, a, d, dist)
                   == trace.any_hit(scene, a, d, dist)).float().mean())
    say("occupancy_march", lanes=MARCH_LANES, march_ms=round(march_ms, 4),
        b1_any_hit_ms=round(any_hit_ms, 4), agreement=round(agree, 4),
        lane_chunk=occupancy.MARCH_LANES)

    small, cam_s = builtin.cornell_box(BIDIR_SMALL, BIDIR_SMALL, device=dev)
    exact = float(common.render(small, cam_s, lvcbpt.li, _bidir_cfg()).mean())
    scene_s = occupancy.attach(small)
    _, launches = bidir_cell("occupancy_lvcbpt", li_render(scene_s, cam_s, lvcbpt.li),
                             _bidir_cfg(occupancy_shadows=True), dev, scene_s, cam_s,
                             need=("closest",), exact_mean=round(exact, 6))
    if launches["occupancy_lvcbpt"]["brute_any_hit"]:
        raise AssertionError(f"occupancy_lvcbpt: shadow rays took B1: {launches}")
    out.update(launches)
    return out


def phase_aov(dev):
    """[aov]: depth, normal, ao and motion (the camera moving MOTION_SHIFT
    over the shutter) at 256x256 x 4 spp through common.render; then
    multichannel.render at 256x256 x 4 spp, its radiance channel equal to
    common.render(path.li) of the same seed within 1e-4. Returns B1's
    launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import aov, common, multichannel, path
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    end = cam.to_world.clone()
    end[0, 3] += MOTION_SHIFT
    cfg = _bidir_cfg(AOV_SPP)
    out = {}
    for name, li, need in (("depth", aov.li_depth, ("closest",)),
                           ("normal", aov.li_normal, ("closest",)),
                           ("ao", aov.li_ao, ("closest", "any_hit")),
                           ("motion", aov.li_motion, ("closest",))):
        c = cam.replace(to_world_end=end) if name == "motion" else cam
        img, launches = bidir_cell(f"aov_{name}", li_render(scene, c, li), cfg, dev, scene, c,
                                   need=need)
        if not float(img.abs().max()) > 0:
            raise AssertionError(f"aov_{name}: an all-zero image")
        out.update(launches)
    img, launches = bidir_cell("multichannel",
                               lambda c: multichannel.render(scene, cam, c)["radiance"], cfg,
                               dev, scene, cam)
    out.update(launches)
    want = common.render(scene, cam, path.li, cfg)
    diff = float((img - want).abs().max())
    say("multichannel_check", max_abs_diff=diff, bar=MULTICHANNEL_TOL)
    if not torch.allclose(img, want, rtol=MULTICHANNEL_TOL, atol=MULTICHANNEL_TOL):
        raise AssertionError(f"multichannel radiance against common.render(path.li): {diff}")
    return out


def phase_bidir_mesh(dev):
    """[bidir_mesh]: sphere_shadow (10,372 triangles, BVH attached) at
    128x128 x 16 spp, depth 4, through bdpt.li and lvcbpt.li: every search
    on B2 (none on B1), every kept launch equal to the walk's (check_kept);
    the means beside path.li's. Returns B2's launches by path."""
    from mitsuba_tpu_torch.integrators import bdpt, lvcbpt
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_SMALL
    scene, cam, _ = builtin.sphere_shadow(width=w, height=w, attach_bvh=True, device=dev)
    ref = path_mean(scene, cam, 4, dev)
    out = {}
    for name, li in (("bidir_mesh_bdpt", bdpt.li), ("bidir_mesh_lvcbpt", lvcbpt.li)):
        out.update(bidir_cell(name, li_render(scene, cam, li), _bidir_cfg(depth=4), dev, scene,
                              cam, kernel="b2", path_mean_for_comparison=round(ref, 6))[1])
    return out


def phase_cli_bidir(dev):
    """[cli_bidir]: [cli_cornell]'s scene files with --integrator lvcbpt and
    with --integrator ptracer at -s CLI_BIDIR_SPP, each by the real command
    (wall time) and by
    cli.main in process (B1's launches counted and twin checked); each EXR
    against the in-process render of the loaded scene: lvcbpt at the
    goldens' bar (check_golden), ptracer at C31's per-pixel bar (its
    splats' atomic order); the device busy share of each at 4 spp.
    Returns B1's launches by path."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.integrators import common, lvcbpt, ptracer
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import xml

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path = cli_cornell_files(tmp, dev)[0]
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
        lcfg = dataclasses.replace(lcfg, spp=CLI_BIDIR_SPP)
        for name, make in (("lvcbpt", lambda c: common.render(loaded, lcam, lvcbpt.li, c)),
                           ("ptracer", lambda c: ptracer.render(loaded, lcam, c))):
            want = make(lcfg).cpu().numpy()
            args = ["--integrator", name, "-s", str(CLI_BIDIR_SPP)]
            wall = run_cli_subprocess(xml_path, tmp / f"sub_{name}.exr", args)
            launches, checked, times = run_cli_counted(
                bk, [xml_path, "-o", tmp / f"in_{name}.exr", *args], dev)
            imgs = [image.read_exr(tmp / f"{k}_{name}.exr") for k in ("sub", "in")]
            if name == "ptracer":
                fit = {"max_abs_diff": [float(np.abs(im - want).max()) for im in imgs],
                       "bar": [SPLAT_RTOL, SPLAT_ATOL]}
                if not all(np.allclose(im, want, rtol=SPLAT_RTOL, atol=SPLAT_ATOL)
                           for im in imgs):
                    raise AssertionError(f"cli_ptracer: the EXRs against the in-process "
                                         f"render: {fit}")
            else:
                checks = [check_golden(im, want) for im in imgs]
                fit = {"pixels_off": [c[0] for c in checks],
                       "max_abs_diff": [c[1] for c in checks]}
            say(f"cli_{name}", resolution=f"{lcam.width}x{lcam.height}", spp=lcfg.spp,
                subprocess_wall_s=round(wall, 3), **times, b1_launches=launches,
                twin_checked_rays=checked, twin_mismatches=0, **fit,
                mean_radiance=round(float(imgs[1].mean()), 6))
            small = dataclasses.replace(lcfg, spp=BIDIR_PROFILE_SPP)
            profile_call(f"cli_{name}", lambda: make(small), dev,
                         resolution=f"{lcam.width}x{lcam.height}", spp=small.spp)
            out.update(path_launches(f"cli_{name}", launches))
    return out


BIDIR_PHASES = (phase_bdpt, phase_lvcbpt, phase_ptracer_vpl, phase_occupancy, phase_aov,
                phase_bidir_mesh, phase_cli_bidir)


# ---------------------------------------------------------------------------
# the photon-mapping family (the [photon] group)
# ---------------------------------------------------------------------------

PHOTON_WIDTH = 256
SPPM_PASSES = 16                # the JAX defaults: 16 passes x 2^17 photons
SPPM_PHOTONS = 1 << 17
SPPM_DIRECT_PASSES = 2          # the JAX package's gather (C37): printed only
CPPM_PASSES = 4
PM_PHOTONS = 1 << 18
PM_PASSES = 4
BRE_PATHS = 1 << 16
BRE_STEPS = 24
IRR_POINTS, IRR_HEMI, IRR_DEPTH, IRR_SPP = 4096, 64, 3, 16
SPECTRAL_SPP = 16
ADAPTIVE_BASE, ADAPTIVE_BATCH, ADAPTIVE_MAX = 8, 8, 64
PHOTON_MESH_PASSES = 4
PHOTON_CLI_SPP = 16             # -s 16: sppm 4 passes, spectral 16 spp
# the JAX tests' bars
SPPM_RTOL = 0.15                # tests/test_sppm.py:61
SPPM_MEDIAN_GAP = 0.3           # tests/test_sppm.py:62-64, pixels brighter than 0.1
PM_RTOL = 0.20                  # tests/test_photonmapper.py:21
PM_MIN_DEPOSITS = 50            # tests/test_photonmapper.py:35-36
BRE_RANGE = (0.1, 1.5)          # tests/test_bre.py:22-23, x volpath's mean
BRE_FOG = ([0.6] * 3, [0.05] * 3)
IRR_RTOL, IRR_OVER_DIRECT = 0.05, 1.05      # tests/test_irrcache.py:24-28
SPECTRAL_RTOL = 0.05            # tests/test_spectral.py:62, per channel
ADAPTIVE_RTOL = 0.08            # tests/test_more_integrators.py:53
ADAPTIVE_MAX_ERROR = 0.02       # tests/test_more_integrators.py:46
R2_RTOL = 1e-6


def ref_image(scene, cam, li, depth):
    """common.render(li) at BIDIR_REF_SPP, the given depth, seed 0: the
    reference image of the photon group's checks."""
    import torch

    from mitsuba_tpu_torch.integrators import common

    with torch.no_grad():
        return common.render(scene, cam, li, _bidir_cfg(BIDIR_REF_SPP, depth))


def sppm_scopes():
    """The scopes of an SPPM pass (profile_call's and pass_split's): the
    camera pass, the photon pass, the hash grid's build and its query (the
    gather with its BSDF evaluations)."""
    from mitsuba_tpu_torch.integrators import sppm
    from mitsuba_tpu_torch.ops import hashgrid

    return {"camera": (sppm, "_camera_pass"), "photon": (sppm, "_photon_pass"),
            "build": (hashgrid, "build"), "query": (hashgrid, "query_sum")}


def pass_split(make, dev):
    """One call of make() with each scope of sppm_scopes ended by a
    synchronise: ({scope: wall seconds}, the call's wall seconds)."""
    import torch

    spent = {}

    def clocked(label, fn):
        def call(*args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(dev)
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
            return out
        return call

    with contextlib.ExitStack() as stack:
        for label, (mod, fn) in sppm_scopes().items():
            stack.enter_context(mock.patch.object(mod, fn, clocked(label, getattr(mod, fn))))
        _, wall = timed(make, dev)
    return spent, wall


def sppm_maker(scene, cam, runs, **kw):
    """make(cfg) of a bidir_cell: sppm.render with cfg.spp passes (one camera
    sample a pixel a pass); each call appends its statistics to `runs`."""
    from mitsuba_tpu_torch.integrators import sppm

    def make(cfg):
        img, st = sppm.render(scene, cam, cfg, n_passes=cfg.spp, **kw)
        runs.append(st)
        return img
    return make


def check_sppm(name, img, ref, st, hold_gap=True):
    """SPPM's bars against path.li's image `ref`: non-negative and, with
    hold_gap, the median relative gap over pixels brighter than 0.1 under
    0.3. Prints the render's truncated counts (st, its statistics)."""
    import torch

    lit = ref.mean(-1) > 0.1
    gap = float(torch.median(((img.mean(-1) - ref.mean(-1)).abs() / ref.mean(-1))[lit]))
    say(f"{name}_check", truncated=list(st["truncated"]), median_gap=round(gap, 5),
        bar=SPPM_MEDIAN_GAP if hold_gap else None, lit_pixels=int(lit.sum()),
        min=float(img.min()))
    if not (float(img.min()) >= 0 and (gap < SPPM_MEDIAN_GAP or not hold_gap)):
        raise AssertionError(f"{name}: min {float(img.min())}, median gap {gap}")


def phase_sppm(dev):
    """[sppm]: sppm.render on the Cornell box at 256x256, RADIUS_SPPM, 16
    passes x 2^17 photons, depth 8: its mean within 15% of path.li's (64
    spp), the median relative gap over pixels brighter than 0.1 under 0.3,
    the truncated counts; [sppm_pass]: seconds a pass and one pass's wall
    shares of the camera pass, the photon pass, the grid's build and the
    query (the device shares are in its [profile] line);
    [sppm_direct_photons]: the JAX package's gather, first-hit photons
    included (ROADMAP C37), SPPM_DIRECT_PASSES passes, finite, its mean
    beside path's, not held to it. [cppm_constant],
    [cppm_linear]: 4 passes each, finite and non-negative, r2 after pass n
    equal to r2_0 (constant) and to r2_0 / (n + 1) (linear). Returns B1's
    launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import path, sppm
    from mitsuba_tpu_torch.scene import builtin

    w = PHOTON_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    ref = ref_image(scene, cam, path.li, BIDIR_DEPTH)
    ref_mean = float(ref.mean())
    runs = []
    img, out = bidir_cell("sppm", sppm_maker(scene, cam, runs, photons_per_pass=SPPM_PHOTONS),
                          _bidir_cfg(SPPM_PASSES), dev, scene, cam, ref_mean, SPPM_RTOL,
                          scopes=sppm_scopes(), passes=SPPM_PASSES,
                          photons_per_pass=SPPM_PHOTONS)
    check_sppm("sppm", img, ref, runs[0])
    spent, wall = pass_split(lambda: sppm.render(scene, cam, _bidir_cfg(), n_passes=1,
                                                 photons_per_pass=SPPM_PHOTONS), dev)
    say("sppm_pass", pass_wall_s=round(wall, 4), wall_share={
        k: round(v / wall, 4) for k, v in spent.items()},
        peak_gb=round(torch.cuda.max_memory_allocated(dev) / 1e9, 3))
    # the JAX package's gather, first hits included (C37): printed, not held
    (jimg, jst), render_s = timed(lambda: sppm.render(
        scene, cam, _bidir_cfg(), n_passes=SPPM_DIRECT_PASSES, photons_per_pass=SPPM_PHOTONS,
        direct_photons=True), dev)
    say("sppm_direct_photons", passes=SPPM_DIRECT_PASSES, render_s=round(render_s, 4),
        mean_radiance=round(float(jimg.mean()), 6),
        rel_to_path=round(float(jimg.mean()) / ref_mean - 1.0, 5),
        truncated=list(jst["truncated"]))
    require_finite("sppm_direct_photons", jimg, tuple(img.shape))

    r2_0 = np.float32((sppm.scene_extent(scene) * 5.0 / w) ** 2)
    for name, strategy in (("cppm_constant", sppm.RADIUS_CONSTANT),
                           ("cppm_linear", sppm.RADIUS_LINEAR)):
        runs = []
        img, launches = bidir_cell(
            name, sppm_maker(scene, cam, runs, photons_per_pass=SPPM_PHOTONS,
                             strategy=strategy),
            _bidir_cfg(CPPM_PASSES), dev, scene, cam, passes=CPPM_PASSES,
            path_mean_for_comparison=round(ref_mean, 6))
        out.update(launches)
        want = r2_0 / (1.0 if strategy == sppm.RADIUS_CONSTANT else CPPM_PASSES + 1.0)
        r2_off = float(((runs[0]["r2"] - want).abs() / want).max())
        say(f"{name}_check", r2_0=float(r2_0), r2_expected=float(want),
            r2_max_rel_diff=r2_off, bar=R2_RTOL, min=float(img.min()))
        if not (float(img.min()) >= 0 and r2_off <= R2_RTOL):
            raise AssertionError(f"{name}: min {float(img.min())}, r2 off by {r2_off}")
    return out


def phase_photonmapper(dev):
    """[photonmapper]: photonmapper.render on the Cornell box at 256x256,
    2^18 photons a pass, 4 passes, depth 8: within 20% of path.li's mean.
    [photon_tags]: caustic_box's photon pass (2^18 photons, depth 8) holds
    more than 50 caustic and 50 indirect deposits. Returns B1's launches by
    path."""
    from mitsuba_tpu_torch.integrators import photonmapper, sppm
    from mitsuba_tpu_torch.scene import builtin

    w = PHOTON_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    out = dict(bidir_cell(
        "photonmapper",
        lambda c: photonmapper.render(scene, cam, c, n_photons=PM_PHOTONS, n_passes=c.spp),
        _bidir_cfg(PM_PASSES), dev, scene, cam, path_mean(scene, cam, BIDIR_DEPTH, dev),
        PM_RTOL, passes=PM_PASSES, photons=PM_PHOTONS)[1])
    caustic_scene, _ = builtin.caustic_box(BIDIR_SMALL, BIDIR_SMALL, device=dev)
    _, _, _, valid, depth, prev = sppm._photon_pass(caustic_scene, _bidir_cfg(), 0, PM_PHOTONS,
                                                    BIDIR_DEPTH, with_tags=True)
    caustic = int((valid & prev & (depth >= 1)).sum())
    indirect = int((valid & ~prev & (depth >= 1)).sum())
    say("photon_tags", scene="caustic_box", photons=PM_PHOTONS, caustic_deposits=caustic,
        indirect_deposits=indirect, bar=PM_MIN_DEPOSITS)
    if min(caustic, indirect) <= PM_MIN_DEPOSITS:
        raise AssertionError(f"caustic_box deposits: caustic {caustic}, indirect {indirect}")
    return out


def phase_bre(dev):
    """[bre]: bre.render on the Cornell box in tests/test_bre.py's fog
    (sigma_s 0.6, sigma_a 0.05) at 256x256, 2^16 light paths, 24 steps: its
    mean between 0.1x and 1.5x volpath.li's (64 spp, depth 8). bre casts no
    shadow ray: only B1's closest-hit entry is needed. Returns B1's
    launches by path."""
    from mitsuba_tpu_torch.integrators import bre, volpath
    from mitsuba_tpu_torch.models import medium
    from mitsuba_tpu_torch.scene import builtin

    w = PHOTON_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    scene = scene.replace(medium=medium.make_homogeneous(*BRE_FOG, g=0.0, device=dev))
    ref = float(ref_image(scene, cam, volpath.li, BIDIR_DEPTH).mean())
    img, out = bidir_cell(
        "bre", lambda c: bre.render(scene, cam, c, n_paths=BRE_PATHS, steps=BRE_STEPS),
        _bidir_cfg(1), dev, scene, cam, need=("closest",), paths=BRE_PATHS, steps=BRE_STEPS)
    ratio = float(img.mean()) / ref
    say("bre_check", volpath_mean=round(ref, 6), ratio_to_volpath=round(ratio, 5),
        bar=BRE_RANGE)
    if not BRE_RANGE[0] < ratio < BRE_RANGE[1]:
        raise AssertionError(f"bre: mean {float(img.mean())} = {ratio} x volpath's {ref}")
    return out


def irrcache_eager(scene, cam, cfg):
    """irrcache.render's work rendered eagerly: the cache, then its film
    through common.render (irrcache.render takes common.render_jit)."""
    from mitsuba_tpu_torch.integrators import common, irrcache

    cache = irrcache.build_cache(scene, cfg, IRR_POINTS, IRR_HEMI, seed=cfg.seed + 77)
    return common.render(scene, cam, irrcache.li_factory(cache), cfg)


def phase_irrcache(dev):
    """[irrcache]: irrcache.render's work, eagerly (irrcache_eager), on the
    Cornell box at 256x256 x 16 spp, depth 3, a cache of 4,096 points x 64
    hemisphere rays: within 5% of path.li's mean and above 1.05x
    direct.li's (both 64 spp, depth 3). Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import direct, path
    from mitsuba_tpu_torch.scene import builtin

    w = PHOTON_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    direct_mean = float(ref_image(scene, cam, direct.li, IRR_DEPTH).mean())
    img, out = bidir_cell(
        "irrcache", lambda c: irrcache_eager(scene, cam, c),
        _bidir_cfg(IRR_SPP, IRR_DEPTH), dev, scene, cam,
        float(ref_image(scene, cam, path.li, IRR_DEPTH).mean()), IRR_RTOL,
        points=IRR_POINTS, hemisphere_rays=IRR_HEMI)
    ratio = float(img.mean()) / direct_mean
    say("irrcache_check", direct_mean=round(direct_mean, 6), ratio_to_direct=round(ratio, 5),
        bar=IRR_OVER_DIRECT)
    if not ratio > IRR_OVER_DIRECT:
        raise AssertionError(f"irrcache: {ratio} x direct's mean")
    return out


def phase_spectral_adaptive(dev):
    """[spectral]: spectral.li through common.render on the gray Cornell
    box (every reflectance 0.6) at 256x256 x 16 spp, depth 8: each channel
    mean within 5% of path.li's (64 spp). [adaptive]: render_adaptive with
    path.li on the Cornell box at 256x256, base 8, batch 8, max 64 spp: the
    spp map adapts and the mean lies within 8% of path.li's. Returns B1's
    launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import path, spectral
    from mitsuba_tpu_torch.scene import builtin
    from mitsuba_tpu_torch.utils import adaptive

    w = PHOTON_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    gray = scene.replace(materials=scene.materials.replace(
        reflectance=torch.full_like(scene.materials.reflectance, 0.6)))
    want = ref_image(gray, cam, path.li, BIDIR_DEPTH).mean((0, 1))
    img, out = bidir_cell("spectral", li_render(gray, cam, spectral.li),
                          _bidir_cfg(SPECTRAL_SPP), dev, gray, cam, fixture="gray cornell_box")
    got = img.mean((0, 1))
    off = float(((got - want).abs().max() / want.mean()))
    say("spectral_check", channel_means=[round(float(x), 6) for x in got],
        path_channel_means=[round(float(x), 6) for x in want], max_rel_gap=round(off, 5),
        bar=SPECTRAL_RTOL)
    if not off < SPECTRAL_RTOL:
        raise AssertionError(f"spectral: channel means {got.tolist()} against {want.tolist()}")

    spp_maps = []

    def make(cfg):
        img, spp_map = adaptive.render_adaptive(
            scene, cam, path.li, cfg, base_spp=min(cfg.spp, ADAPTIVE_BASE),
            batch_spp=ADAPTIVE_BATCH, max_spp=cfg.spp, max_error=ADAPTIVE_MAX_ERROR)
        spp_maps.append(spp_map)
        return img

    img, launches = bidir_cell("adaptive", make, _bidir_cfg(ADAPTIVE_MAX), dev, scene, cam,
                               path_mean(scene, cam, BIDIR_DEPTH, dev), ADAPTIVE_RTOL,
                               samples=lambda: int(spp_maps[0].sum()),
                               base_spp=ADAPTIVE_BASE, batch_spp=ADAPTIVE_BATCH)
    out.update(launches)
    m = spp_maps[0]
    say("adaptive_check", spp_min=float(m.min()), spp_max=float(m.max()),
        spp_mean=round(float(m.mean()), 3))
    if not (float(m.max()) > float(m.min()) and float(m.min()) >= ADAPTIVE_BASE):
        raise AssertionError(f"adaptive: the spp map did not adapt ({float(m.min())}, "
                             f"{float(m.max())})")
    return out


def phase_photon_mesh(dev):
    """[photon_mesh_sppm]: sppm.render on sphere_shadow (10,372 triangles,
    BVH attached) at 128x128, 4 passes x 2^17 photons, depth 8: every
    search on B2 (none on B1), every kept launch equal to the walk's; the
    mean within 15% of path.li's (the median gap printed beside it). Returns
    B2's launches by path."""
    from mitsuba_tpu_torch.integrators import path
    from mitsuba_tpu_torch.scene import builtin

    w = BIDIR_SMALL
    scene, cam, _ = builtin.sphere_shadow(width=w, height=w, attach_bvh=True, device=dev)
    ref = ref_image(scene, cam, path.li, BIDIR_DEPTH)
    runs = []
    img, out = bidir_cell("photon_mesh_sppm",
                          sppm_maker(scene, cam, runs, photons_per_pass=SPPM_PHOTONS),
                          _bidir_cfg(PHOTON_MESH_PASSES), dev, scene, cam, float(ref.mean()),
                          SPPM_RTOL, kernel="b2", passes=PHOTON_MESH_PASSES)
    check_sppm("photon_mesh_sppm", img, ref, runs[0], hold_gap=False)
    return out


def phase_cli_photon(dev):
    """[cli_sppm], [cli_spectral]: [cli_cornell]'s scene files with -s 16 and
    --integrator sppm (4 passes of 2^17 photons) or spectral (16 spp), by
    cli.main in process (B1's launches counted and twin checked); each EXR
    against the in-process render of the loaded scene at the goldens' bar
    (check_golden). Returns B1's launches by path."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.integrators import common, spectral, sppm
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import xml

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path = cli_cornell_files(tmp, dev)[0]
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
        lcfg = dataclasses.replace(lcfg, spp=PHOTON_CLI_SPP)
        for name, make in (
                ("sppm", lambda c: sppm.render(loaded, lcam, c, n_passes=c.spp // 4)[0]),
                ("spectral", lambda c: common.render(loaded, lcam, spectral.li, c))):
            want = make(lcfg).cpu().numpy()
            launches, checked, times = run_cli_counted(
                bk, [xml_path, "-o", tmp / f"in_{name}.exr", "-s", PHOTON_CLI_SPP,
                     "--integrator", name], dev)
            got = image.read_exr(tmp / f"in_{name}.exr")
            flips, max_diff = check_golden(got, want)
            say(f"cli_{name}", resolution=f"{lcam.width}x{lcam.height}", spp=lcfg.spp, **times,
                b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0,
                pixels_off=flips, max_abs_diff=max_diff, mean_radiance=round(float(got.mean()), 6))
            out.update(path_launches(f"cli_{name}", launches))
    return out


PHOTON_PHASES = (phase_sppm, phase_photonmapper, phase_bre, phase_irrcache,
                 phase_spectral_adaptive, phase_photon_mesh, phase_cli_photon)


# ---------------------------------------------------------------------------
# daylight, woven cloth and primary-sample Metropolis (the [daylight] group)
# ---------------------------------------------------------------------------

DAYLIGHT_WIDTH = 256
SUNSKY_SPP = 64
SUNSKY_DEPTH = 8
SUNSKY_SPECTRAL_SPP = 16
SUNSKY_WAVEFRONT_RTOL = 0.01     # the wavefront's mean against common.render's
SUNSKY_PLANE_MIN = 0.1           # tests/test_sunsky.py:101
SUNSKY_SPECTRAL_RTOL = 0.15      # tests/test_sunsky.py:309, on the luminance means
SUNSKY_DIR = (0.3, 0.8, 0.52)
IRAWAN_SPP = 64
IRAWAN_DEPTH = 3
IRAWAN_MIN_MEAN = 0.03           # tests/test_irawan.py:131
IRAWAN_MIN_STD = 0.005           # tests/test_irawan.py:133
IRAWAN_LANES = 1 << 20
# the card against the CPU on the same lanes, at most one lane in 1,024 per
# output beyond the bar (C23's and C36's 4 of 4,096: a last-bit difference
# in a transcendental carried across a branch or amplified): C10's bar on
# the gathered fields and on eval_pdf, C23's sample bar on sample's wo,
# weight and pdf (ROADMAP C41: float32 itself lies 844, 6,130 and 92 lanes
# of 2^20 from float64 at C10's bar there, on the CPU)
IRAWAN_LANE_TOL = 1e-6
IRAWAN_SAMPLE_RTOL, IRAWAN_SAMPLE_ATOL = 1e-4, 1e-5
IRAWAN_MAX_OFF_SHARE = 1.0 / 1024
MCMC_CHAINS = 1 << 15            # the JAX defaults
MCMC_BOOTSTRAP = 1 << 17
MCMC_MUTATIONS = 64              # the CLI's count at -s 64 or below
PSSMLT_RTOL = 0.08               # tests/test_pssmlt.py:19
PSSMLT_MIN_CORR = 0.95           # tests/test_pssmlt.py:27
ERPT_RTOL = 0.10                 # tests/test_more_integrators.py:31
DAYLIGHT_CLI_WIDTH = 128
DAYLIGHT_CLI_SPP = 16


def daylight_xml(width, spp, depth, shapes, emitter=None):
    """A scene file under tests/test_sunsky.py:75-93's sky (sunDirection
    SUNSKY_DIR, turbidity 3, the loader's default resolution of 512: a
    512x256 map), seen from (0, 1, 4), with `shapes` (XML) and `emitter`
    (XML, in place of the sky where given)."""
    sky = emitter or (f'<emitter type="sunsky"><vector name="sunDirection" x="{SUNSKY_DIR[0]}" '
                      f'y="{SUNSKY_DIR[1]}" z="{SUNSKY_DIR[2]}"/>'
                      f'<float name="turbidity" value="3"/></emitter>')
    return (f'<scene version="0.6.0"><integrator type="path"><integer name="maxDepth" '
            f'value="{depth}"/></integrator><sensor type="perspective"><transform '
            f'name="toWorld"><lookat origin="0,1,4" target="0,0,0" up="0,1,0"/></transform>'
            f'<sampler type="independent"><integer name="sampleCount" value="{spp}"/>'
            f'</sampler><film type="hdrfilm"><integer name="width" value="{width}"/>'
            f'<integer name="height" value="{width}"/></film></sensor>{sky}{shapes}</scene>\n')


# tests/test_sunsky.py:88-91's ground (a rectangle scaled by 3), first in the
# file (triangles 0 and 1), and a cube on it
GROUND_XML = ('<shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="-90"/>'
              '<scale value="3"/></transform><bsdf type="diffuse"/></shape>')
CUBE_XML = ('<shape type="cube"><transform name="toWorld"><scale value="0.4"/>'
            '<translate y="0.4"/></transform><bsdf type="diffuse"><rgb name="reflectance" '
            'value="0.6, 0.45, 0.3"/></bsdf></shape>')


def irawan_xml(preset, width, spp, depth):
    """tests/test_irawan.py:101-123's quad under a constant light, `preset`
    at repeatU = repeatV = 6."""
    return (f'<scene version="0.6.0"><integrator type="path"><integer name="maxDepth" '
            f'value="{depth}"/></integrator><sensor type="perspective"><float name="fov" '
            f'value="40"/><transform name="toWorld"><lookat origin="0, 0.4, 2.2" '
            f'target="0, 0, 0" up="0, 1, 0"/></transform><sampler type="independent">'
            f'<integer name="sampleCount" value="{spp}"/></sampler><film type="hdrfilm">'
            f'<integer name="width" value="{width}"/><integer name="height" value="{width}"/>'
            f'</film></sensor><emitter type="constant"><rgb name="radiance" value="1, 1, 1"/>'
            f'</emitter><shape type="rectangle"><transform name="toWorld"><rotate x="1" '
            f'angle="-90"/></transform><bsdf type="irawan"><string name="preset" '
            f'value="{preset}"/><float name="repeatU" value="6"/><float name="repeatV" '
            f'value="6"/></bsdf></shape></scene>\n')


def load_scene_text(text, dev):
    """load_xml of a scene file written from `text` in a temporary folder."""
    import tempfile

    from mitsuba_tpu_torch.scene import xml

    with tempfile.TemporaryDirectory() as tmp:
        p = Path(tmp) / "scene.xml"
        p.write_text(text)
        return xml.load_xml(p, device=dev)


def primary_prims(scene, cam):
    """The triangle each pixel centre's camera ray hits, -1 where it misses
    (one closest-hit query outside the counted renders)."""
    import torch

    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.ops import trace

    w, h = cam.width, cam.height
    ys, xs = torch.meshgrid(torch.arange(h, device=scene.device),
                            torch.arange(w, device=scene.device), indexing="ij")
    n = w * h
    o, d, _ = sensor.sample_rays(cam, xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5,
                                 torch.full((n, 2), 0.5, device=scene.device))
    its = trace.closest_hit(scene, o, d)
    return torch.where(its.valid, its.prim.long(), -1).reshape(h, w)


def luminance(img):
    import torch

    return float((img @ torch.tensor([0.2126, 0.7152, 0.0722], device=img.device)).mean())


def phase_sunsky(dev):
    """[sunsky]: the ground and a cube under tests/test_sunsky.py's sunsky,
    loaded from a scene file (the 512x256 envmap and its 11-band stack),
    at 256x256 x 64 spp, path depth 8, through the wavefront on B1;
    [sunsky_check]: its mean within 1% of common.render's with path.li, the
    ground's pixels (their primary hit on triangles 0-1) above the JAX
    test's 0.1. [sunsky_spectral]: spectral.li on the true band stack at
    16 spp, its luminance mean within 15% of the RGB render's
    (tests/test_sunsky.py:309). Returns B1's launches by path."""
    import dataclasses

    from mitsuba_tpu_torch.integrators import common, path, spectral, wavefront

    w = DAYLIGHT_WIDTH
    scene, cam, cfg, _ = load_scene_text(daylight_xml(w, SUNSKY_SPP, SUNSKY_DEPTH,
                                                      GROUND_XML + CUBE_XML), dev)
    img, out = bidir_cell("sunsky", lambda c: wavefront.render(scene, cam, c), cfg, dev, scene,
                          cam, envmap=list(scene.envmap.image.shape),
                          bands=scene.envmap.spectral.shape[-1])
    ref = common.render(scene, cam, path.li, cfg)
    prims = primary_prims(scene, cam)
    ground = (prims >= 0) & (prims < 2)
    mean, ref_mean = float(img.mean()), float(ref.mean())
    ground_mean = float(img.mean(-1)[ground].mean())
    gap = abs(mean - ref_mean) / ref_mean
    say("sunsky_check", wavefront_mean=round(mean, 6), path_mean=round(ref_mean, 6),
        rel_gap=round(gap, 5), bar=SUNSKY_WAVEFRONT_RTOL, ground_pixels=int(ground.sum()),
        ground_mean=round(ground_mean, 6), ground_min_mean=SUNSKY_PLANE_MIN)
    if not (gap < SUNSKY_WAVEFRONT_RTOL and ground_mean > SUNSKY_PLANE_MIN):
        raise AssertionError(f"sunsky: wavefront {mean} against {ref_mean}, ground {ground_mean}")

    spec, launches = bidir_cell("sunsky_spectral", li_render(scene, cam, spectral.li),
                                dataclasses.replace(cfg, spp=SUNSKY_SPECTRAL_SPP), dev, scene, cam)
    out.update(launches)
    ls, lr = luminance(spec), luminance(ref)
    say("sunsky_spectral_check", luminance=round(ls, 6), rgb_luminance=round(lr, 6),
        rel_gap=round(abs(ls - lr) / lr, 5), bar=SUNSKY_SPECTRAL_RTOL)
    if not abs(ls - lr) / lr < SUNSKY_SPECTRAL_RTOL:
        raise AssertionError(f"sunsky_spectral: luminance {ls} against the RGB render's {lr}")
    return out


def phase_daylight_mesh(dev):
    """[daylight_mesh]: bench.py's big mesh (the 70,034-triangle displaced
    sphere, BVH attached) under the same sky (sunsky.bake at resolution
    512 beside its area light), at its configuration, 128x128 x 16 spp,
    depth 4, rr 3, through path.li: every search on B2, none on B1.
    Returns B2's launches by path."""
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.models import emitter, sunsky
    from mitsuba_tpu_torch.scene import builtin, envmap

    scene, cam = builtin.displaced_sphere(device=dev)
    sky = sunsky.bake("sunsky", sun_dir=np.asarray(SUNSKY_DIR, np.float64), turbidity=3.0)
    scene = emitter.compute_group_probs(envmap.attach_envmap(scene, sky))
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
    return bidir_cell("daylight_mesh", li_render(scene, cam, path.li), cfg, dev, scene, cam,
                      kernel="b2", envmap=list(scene.envmap.image.shape))[1]


def irawan_lanes(dev):
    """[irawan_lanes]: gather_yarn, eval_pdf and sample of the Irawan family
    on IRAWAN_LANES lanes (three weave slots: cotton with the Perlin umax
    perturbation and the intensity variation on, silk, cotton; uv in
    [-2, 3)^2) on the card against the same calls on the CPU: the gathered
    fields and eval_pdf at C10's bar, sample's outputs at C23's, each with
    at most IRAWAN_MAX_OFF_SHARE of the lanes beyond."""
    import torch

    from mitsuba_tpu_torch.models import bsdf, cloth
    from mitsuba_tpu_torch.scene import ir

    perturbed = cloth.PRESET_COTTON.replace(
        "fineness = 0.0, period = 0.0",
        "fineness = 3.0, period = 2.0, dWarpUmaxOverDWarp = 10.0, dWarpUmaxOverDWeft = 8.0, "
        "dWeftUmaxOverDWarp = 6.0, dWeftUmaxOverDWeft = 4.0")
    entries = []
    for text, rep in ((perturbed, 6.0), (cloth.PRESET_SILK, 2.0), (cloth.PRESET_COTTON, 1.0)):
        pat = cloth.parse_weave(text)
        cloth.compute_normalization(pat)
        entries.append((pat, rep, rep))
    slots = {1: 0, 3: 1, 4: 2}
    n = IRAWAN_LANES
    rs = np.random.RandomState(11)
    uv = rs.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    mat = rs.choice(sorted(slots), n).astype(np.int32)
    wi, wo = (rs.normal(size=(n, 3)) for _ in range(2))
    wi[:, 2], wo[:, 2] = np.abs(wi[:, 2]), np.abs(wo[:, 2])
    wi, wo = ((v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32) for v in (wi, wo))
    u = rs.uniform(size=(n, 3)).astype(np.float32)
    fams = (ir.BSDF_IRAWAN,)

    def run(device):
        t = {k: torch.from_numpy(v).to(device) for k, v in
             dict(uv=uv, mat=mat, wi=wi, wo=wo, u=u).items()}
        over = cloth.gather_yarn(cloth.build_tables(entries, 5, slots, device=device),
                                 t["mat"], t["uv"])
        sp = bsdf.ShadePoint(type=torch.full((n,), ir.BSDF_IRAWAN, dtype=torch.int32,
                                             device=device), **over)
        f, pdf = bsdf.eval_pdf(sp, t["wi"], t["wo"], fams)
        wo_s, weight, pdf_s, _ = bsdf.sample(sp, t["wi"], t["u"][:, 0], t["u"][:, 1:], fams)
        outs = {**over, "f": f, "pdf": pdf, "wo": wo_s, "weight": weight, "pdf_s": pdf_s}
        return {k: v.cpu().numpy().astype(np.float64) for k, v in outs.items()}

    (card, card_s), cpu = timed(lambda: run(dev), dev), run("cpu")
    sampled = ("wo", "weight", "pdf_s")
    off = {}
    for k, want in cpu.items():
        rtol, atol = ((IRAWAN_SAMPLE_RTOL, IRAWAN_SAMPLE_ATOL) if k in sampled
                      else (IRAWAN_LANE_TOL, IRAWAN_LANE_TOL))
        bad = ~np.isclose(card[k], want, rtol=rtol, atol=atol)
        off[k] = int(bad.reshape(n, -1).any(-1).sum())
    worst = {k: float(np.abs(card[k] - cpu[k]).max()) for k in cpu}
    say("irawan_lanes", lanes=n, card_s=round(card_s, 4), lanes_off=off,
        max_abs_diff={k: f"{v:.3g}" for k, v in worst.items()},
        bar={"c10": IRAWAN_LANE_TOL, "sample": [IRAWAN_SAMPLE_RTOL, IRAWAN_SAMPLE_ATOL]},
        max_off=int(n * IRAWAN_MAX_OFF_SHARE))
    if max(off.values()) > n * IRAWAN_MAX_OFF_SHARE or not all(
            np.isfinite(v).all() for v in card.values()):
        raise AssertionError(f"irawan_lanes: lanes beyond the bars {off}")


def phase_irawan(dev):
    """[irawan_cotton], [irawan_silk]: tests/test_irawan.py's quad under a
    constant light, loaded from a scene file (the preset at repeat 6: the
    staple and the filament integrand), at 256x256 x 64 spp, path depth 3,
    through path.li on B1; [irawan_check]: each image's mean above 0.03
    and its standard deviation above 0.005 (the weave shows). Then
    [irawan_lanes]. Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import path

    out, stats = {}, {}
    for preset in ("cotton", "silk"):
        scene, cam, cfg, _ = load_scene_text(
            irawan_xml(preset, DAYLIGHT_WIDTH, IRAWAN_SPP, IRAWAN_DEPTH), dev)
        img, launches = bidir_cell(f"irawan_{preset}", li_render(scene, cam, path.li), cfg, dev,
                                   scene, cam, spec_norm=round(float(scene.cloth.patp[0, 7]), 4))
        out.update(launches)
        stats[preset] = (float(img.mean()), float(img.std()))
    say("irawan_check", **{p: {"mean": round(m, 6), "std": round(s, 6)}
                           for p, (m, s) in stats.items()},
        bars={"mean": IRAWAN_MIN_MEAN, "std": IRAWAN_MIN_STD})
    if not all(m > IRAWAN_MIN_MEAN and s > IRAWAN_MIN_STD for m, s in stats.values()):
        raise AssertionError(f"irawan: mean and std {stats}")
    irawan_lanes(dev)
    return out


def blurred_corr(a, b, k=3):
    """tests/test_pssmlt.py:20-27: the correlation of the two images' 3x3
    box-blurred channel means."""
    from numpy.lib.stride_tricks import sliding_window_view

    def blur(x):
        pad = np.pad(x.mean(-1), k // 2, mode="edge")
        return sliding_window_view(pad, (k, k)).mean((-1, -2))
    return float(np.corrcoef(blur(a).ravel(), blur(b).ravel())[0, 1])


def phase_mcmc(dev):
    """[pssmlt], [erpt]: pssmlt.render and erpt.render on the Cornell box at
    256x256, depth 8, with the JAX defaults (2^15 chains, 2^17 bootstrap
    paths) and MCMC_MUTATIONS mutations (the cell's spp; its [profile] line
    runs 4), through B1; samples_per_s counts path evaluations (bootstrap +
    chains x (mutations + 1)). Each mean within its JAX test's bar of
    path.li's (64 spp): 8% and 10%; pssmlt's blurred image correlated with
    path.li's above 0.95 ([pssmlt_check]). Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import erpt, path, pssmlt
    from mitsuba_tpu_torch.scene import builtin

    w = DAYLIGHT_WIDTH
    scene, cam = builtin.cornell_box(w, w, device=dev)
    ref = ref_image(scene, cam, path.li, BIDIR_DEPTH)
    evaluations = MCMC_BOOTSTRAP + MCMC_CHAINS * (MCMC_MUTATIONS + 1)
    out = {}
    for name, make, rtol in (
            ("pssmlt", lambda c: pssmlt.render(scene, cam, c, n_chains=MCMC_CHAINS,
                                               n_mutations=c.spp, n_bootstrap=MCMC_BOOTSTRAP),
             PSSMLT_RTOL),
            ("erpt", lambda c: erpt.render(scene, cam, c, n_chains=MCMC_CHAINS,
                                           chain_length=c.spp, n_bootstrap=MCMC_BOOTSTRAP),
             ERPT_RTOL)):
        with deterministic():
            img, launches = bidir_cell(name, make, _bidir_cfg(MCMC_MUTATIONS), dev, scene, cam,
                                       float(ref.mean()), rtol, samples=evaluations,
                                       chains=MCMC_CHAINS, bootstrap=MCMC_BOOTSTRAP,
                                       mutations=MCMC_MUTATIONS, evaluations=evaluations,
                                       algorithms="deterministic")
        out.update(launches)
        if name == "pssmlt":
            corr = blurred_corr(ref.cpu().numpy(), img.cpu().numpy())
            say("pssmlt_check", blurred_corr=round(corr, 5), bar=PSSMLT_MIN_CORR)
            if not corr > PSSMLT_MIN_CORR:
                raise AssertionError(f"pssmlt: blurred correlation {corr}")
    return out


def phase_cli_daylight(dev):
    """[cli_daylight]: a scene file with a sunsky and an irawan rectangle
    (cotton at repeat 6, the ground of [sunsky] scaled by 3) at 128x128 x 16
    spp, path depth 3, by the real command as a subprocess (wall time) and
    by cli.main in process (B1's launches counted and twin checked); both
    EXRs against common.render of the loaded scene at the goldens' bar
    (check_golden). [cli_pssmlt], [cli_erpt]: [cli_cornell]'s scene files
    with --integrator pssmlt / erpt and -s 16 (64 mutations, the JAX
    defaults' chains and bootstrap paths) by cli.main in process, each mean
    within its JAX test's bar of path.li's render of the loaded scene.
    Returns B1's launches by path."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import xml

    cloth_ground = GROUND_XML.replace(
        '<bsdf type="diffuse"/>', '<bsdf type="irawan"><string name="preset" value="cotton"/>'
        '<float name="repeatU" value="6"/><float name="repeatV" value="6"/></bsdf>')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path = tmp / "daylight.xml"
        xml_path.write_text(daylight_xml(DAYLIGHT_CLI_WIDTH, DAYLIGHT_CLI_SPP, IRAWAN_DEPTH,
                                         cloth_ground + CUBE_XML))
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
        want = common.render(loaded, lcam, path.li, lcfg).cpu().numpy()
        wall = run_cli_subprocess(xml_path, tmp / "sub.exr")
        launches, checked, times = run_cli_counted(bk, [xml_path, "-o", tmp / "in.exr"], dev)
        checks = [check_golden(image.read_exr(tmp / f"{k}.exr"), want) for k in ("sub", "in")]
        say("cli_daylight", resolution=f"{lcam.width}x{lcam.height}", spp=lcfg.spp,
            tris=loaded.num_triangles, envmap=list(loaded.envmap.image.shape),
            subprocess_wall_s=round(wall, 3), **times, b1_launches=launches,
            twin_checked_rays=checked, twin_mismatches=0,
            pixels_off=[c[0] for c in checks], max_abs_diff=[c[1] for c in checks],
            mean_radiance=round(float(want.mean()), 6))
        out.update(path_launches("cli_daylight", launches))

        xml_path = cli_cornell_files(tmp, dev)[0]
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
        ref = float(common.render(loaded, lcam, path.li, lcfg).mean())
        for name, rtol in (("pssmlt", PSSMLT_RTOL), ("erpt", ERPT_RTOL)):
            launches, checked, times = run_cli_counted(
                bk, [xml_path, "-o", tmp / f"{name}.exr", "-s", DAYLIGHT_CLI_SPP,
                     "--integrator", name], dev)
            got = image.read_exr(tmp / f"{name}.exr")
            mean = float(got.mean())
            say(f"cli_{name}", resolution=f"{lcam.width}x{lcam.height}", spp=DAYLIGHT_CLI_SPP,
                mutations=max(DAYLIGHT_CLI_SPP, 64), **times, b1_launches=launches,
                twin_checked_rays=checked, twin_mismatches=0, mean_radiance=round(mean, 6),
                path_mean=round(ref, 6), rel_to_path=round(abs(mean - ref) / ref, 5), bar=rtol)
            if not (np.isfinite(got).all() and abs(mean - ref) <= rtol * ref):
                raise AssertionError(f"cli_{name}: mean {mean} against path's {ref}")
            out.update(path_launches(f"cli_{name}", launches))
    return out


DAYLIGHT_PHASES = (phase_sunsky, phase_daylight_mesh, phase_irawan, phase_mcmc,
                   phase_cli_daylight)


# --- path-space MLT and the tools -------------------------------------------------

MANIFOLD_LANES = 1 << 18
MANIFOLD_TWIN_LANES = 4096
MANIFOLD_TOL = 2e-3              # tests/test_manifold.py:68-74
MANIFOLD_MIN_OK = 0.999
MANIFOLD_TWIN_TOL = 1e-6         # C10
MLT_WIDTH = 256
MLT_CHAINS = 1 << 14             # the JAX defaults (mlt.py:600-601)
MLT_BOOTSTRAP = 1 << 16
MLT_MUTATIONS = 64               # the CLI's count at -s 64 or below
MLT_CAUSTIC_MUTATIONS = 24       # four cycles of the six kernels
MLT_CAUSTIC_DEPTH = 4
MLT_GLASS_WIDTH = 128
MLT_GLASS_DEPTH = 5
MLT_GLASS_MUTATIONS = 24
MLT_CLI_SPP = 16
MLT_CLI_DAYLIGHT_WIDTH = 64
MLT_RTOL = 0.06                  # tests/test_mlt.py:21
MLT_CAUSTIC_RTOL = 0.12          # tests/test_mlt_manifold.py:30
MLT_F_MIN_ACCEPT = 0.05          # tests/test_mlt_manifold.py:34
MLT_GLASS_RTOL = 0.15            # tests/test_mlt_manifold.py:82
MTSIMPORT_WIDTH = 64


def mirror_floor_walk_case(n, seed):
    """tests/test_manifold.py:50-80's flat-mirror protocol on n lanes: the
    mirror z = 0 and the receiver z = 2 (10x10 quads), x0 above the mirror,
    the target on the receiver, the chain started off its solution.
    Returns (build_scene arguments, x0, x1, target, the closed-form
    reflection points)."""
    from mitsuba_tpu_torch.scene import ir, shapes

    v, f, nrm, _ = shapes.rectangle()
    v0 = v * 10.0
    v0[:, 2] = 0.0
    v1 = v * 10.0
    v1[:, 2] = 2.0
    mats = [{"type": ir.BSDF_CONDUCTOR, "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14],
             "specular": [1.0, 1.0, 1.0]},
            {"type": ir.BSDF_DIFFUSE, "reflectance": [0.7, 0.7, 0.7]}]
    parts = ((np.concatenate([v0, v1]), np.concatenate([f, f[:, ::-1] + 4]),
              np.asarray([0, 0, 1, 1], np.int32), mats), np.concatenate([nrm, -nrm]))
    rng = np.random.default_rng(seed)
    x0 = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          rng.uniform(0.5, 1.5, n)]).astype(np.float32)
    tgt = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                           np.full(n, 2.0)]).astype(np.float32)
    x1 = np.column_stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                          np.zeros(n)]).astype(np.float32)
    x0m = x0 * np.asarray([1, 1, -1], np.float32)
    s = (0.0 - x0m[:, 2]) / (tgt[:, 2] - x0m[:, 2])
    return parts, x0, x1, tgt, x0m + s[:, None] * (tgt - x0m)


def phase_manifold_walk(dev):
    """[manifold_walk]: manifold.walk on MANIFOLD_LANES lanes of the
    flat-mirror protocol on the card, every retrace through B1: the
    converged share, the iterations, the chain vertex and the endpoint
    against the closed form (the JAX test's 2e-3, on the converged lanes;
    at least MANIFOLD_MIN_OK converged). Then the first MANIFOLD_TWIN_LANES
    lanes walked on the card and on the CPU: ok and iterations equal,
    positions within C10's bar. Returns B1's launches by path."""
    import torch

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import manifold
    from mitsuba_tpu_torch.scene import ir

    (args, nrm), x0, x1, tgt, p_ref = mirror_floor_walk_case(MANIFOLD_LANES, 3)

    def walk(device, n):
        scene = ir.build_scene(*args, normals=nrm, device=device)
        t = [torch.from_numpy(a[:n]).to(device) for a in (x0, x1)]
        one = torch.ones((n,), dtype=torch.int32, device=device)
        return manifold.walk(scene, t[0], t[1], torch.zeros((n, 1), dtype=torch.int32,
                                                            device=device),
                             one, torch.from_numpy(tgt[:n]).to(device))

    keeping, read = counted()
    with keeping:
        res, walk_s = timed(lambda: walk(dev, MANIFOLD_LANES), dev)
    launches, plain, kept = read()
    if launches["closest"] == 0 or any(plain.values()):
        raise AssertionError(f"manifold_walk bypassed B1: {launches}, plain {plain}")
    checked = check_kept(bk, kept, entries=["closest_key"])
    ok = res.ok.cpu().numpy()
    if not ok.any():
        raise AssertionError("manifold_walk: no lane converged")
    err_end = np.abs(res.end_pos.cpu().numpy() - tgt)[ok].max()
    err_chain = np.abs(res.chain_pos[:, 0].cpu().numpy() - p_ref)[ok].max()
    n = MANIFOLD_TWIN_LANES
    card, cpu = walk(dev, n), walk("cpu", n)
    same_ok = bool(torch.equal(card.ok.cpu(), cpu.ok))
    same_it = bool(torch.equal(card.iterations.cpu(), cpu.iterations))
    pos_diff = max(float((card.chain_pos.cpu() - cpu.chain_pos).abs().max()),
                   float((card.end_pos.cpu() - cpu.end_pos).abs().max()))
    pos_ok = all(np.allclose(a.cpu().numpy(), b.numpy(), rtol=MANIFOLD_TWIN_TOL,
                             atol=MANIFOLD_TWIN_TOL)
                 for a, b in ((card.chain_pos, cpu.chain_pos), (card.end_pos, cpu.end_pos)))
    say("manifold_walk", lanes=MANIFOLD_LANES, walk_s=round(walk_s, 4),
        iterations=int(res.iterations[0]), converged_share=round(float(ok.mean()), 6),
        max_err_end=f"{err_end:.3g}", max_err_chain=f"{err_chain:.3g}", bar=MANIFOLD_TOL,
        b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0)
    say("manifold_walk_twin", lanes=n, ok_equal=same_ok, iterations_equal=same_it,
        iterations=[int(card.iterations[0]), int(cpu.iterations[0])],
        max_abs_diff=f"{pos_diff:.3g}", bar=MANIFOLD_TWIN_TOL)
    if not (ok.mean() >= MANIFOLD_MIN_OK and err_end < MANIFOLD_TOL and err_chain < MANIFOLD_TOL):
        raise AssertionError(f"manifold_walk: converged {ok.mean()}, errors {err_end}, "
                             f"{err_chain}")
    if not (same_ok and same_it and pos_ok):
        raise AssertionError(f"manifold_walk: card against CPU: ok {same_ok}, iterations "
                             f"{same_it}, positions {pos_diff}")
    return path_launches("manifold_walk", launches)


def mlt_maker(scene, cam, runs, **kw):
    """make(cfg) of a bidir_cell: mlt.render with cfg.spp mutations; each
    call appends its statistics to `runs`."""
    from mitsuba_tpu_torch.integrators import mlt

    def make(cfg):
        img, st = mlt.render(scene, cam, cfg, n_mutations=cfg.spp, return_stats=True, **kw)
        runs.append(st)
        return img
    return make


def mlt_cell(name, scene, cam, dev, mutations, depth, rtol, n_modes, min_accept=None,
             ordered=False):
    """One MLT render through bidir_cell (MLT_CHAINS chains from
    MLT_BOOTSTRAP bootstrap paths; samples_per_s counts path evaluations:
    bootstrap + chains x (mutations + 1)), its mean against path.li's at
    64 spp within `rtol`; [<name>_check]: the acceptance of each of the
    n_modes kernels above 0 (kernel F's above `min_accept` where given)
    and b. `ordered`: under deterministic(), for [jit_film] to hold its
    replays against. Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import path

    ref = ref_image(scene, cam, path.li, depth)
    runs = []
    evaluations = MLT_BOOTSTRAP + MLT_CHAINS * (mutations + 1)
    with deterministic() if ordered else contextlib.nullcontext():
        _, launches = bidir_cell(name, mlt_maker(scene, cam, runs, n_chains=MLT_CHAINS,
                                                 n_bootstrap=MLT_BOOTSTRAP),
                                 _bidir_cfg(mutations, depth), dev, scene, cam,
                                 float(ref.mean()), rtol, samples=evaluations,
                                 chains=MLT_CHAINS, bootstrap=MLT_BOOTSTRAP,
                                 mutations=mutations, evaluations=evaluations,
                                 **({"algorithms": "deterministic"} if ordered else {}))
    acc = runs[0]["acceptance"].cpu().numpy()
    say(f"{name}_check", acceptance=[round(float(a), 5) for a in acc],
        b=round(float(runs[0]["b"]), 4), kernels=len(acc), f_bar=min_accept)
    if len(acc) != n_modes or not (acc > 0).all() or (
            min_accept is not None and not acc[5] > min_accept):
        raise AssertionError(f"{name}: acceptance {acc}")
    return launches


def phase_mlt(dev):
    """[mlt]: the headline Cornell box at MLT_WIDTH^2, depth 8, with the JAX
    defaults (2^14 chains, 2^16 bootstrap paths) and MLT_MUTATIONS
    mutations (five kernels), within tests/test_mlt.py's 6% of path.li's
    mean. Returns B1's launches by path."""
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(MLT_WIDTH, MLT_WIDTH, device=dev)
    return mlt_cell("mlt", scene, cam, dev, MLT_MUTATIONS, BIDIR_DEPTH, MLT_RTOL, 5,
                    ordered=True)


def phase_mlt_caustic(dev):
    """[mlt_caustic]: caustic_box with a perfect mirror at MLT_WIDTH^2,
    depth 4, six kernels (the manifold walk runs in kernel F) over
    MLT_CAUSTIC_MUTATIONS mutations: the mean within 12% of path.li's and
    F's acceptance above 0.05 (tests/test_mlt_manifold.py:17-34). Returns
    B1's launches by path."""
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.caustic_box(MLT_WIDTH, MLT_WIDTH, rough=False, device=dev)
    return mlt_cell("mlt_caustic", scene, cam, dev, MLT_CAUSTIC_MUTATIONS, MLT_CAUSTIC_DEPTH,
                    MLT_CAUSTIC_RTOL, 6, MLT_F_MIN_ACCEPT, ordered=True)


def glass_box(width, dev):
    """tests/test_mlt_manifold.py:37-76's box: five white walls, a dark
    emitter quad under the ceiling (radiance 40) and a smooth-glass sphere
    (eta 1.5, 16 rings x 24 segments) at (0.5, 0.45, 0.5), radius 0.22."""
    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.scene import ir, shapes

    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    mats = [{"type": ir.BSDF_DIFFUSE, "reflectance": [0.7, 0.7, 0.7]},
            {"type": ir.BSDF_DIELECTRIC, "eta": [1.5, 1.5, 1.5], "specular": [1.0, 1.0, 1.0],
             "reflectance": [1.0, 1.0, 1.0]},
            {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}]
    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], 0)      # floor
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], 0)      # ceiling
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], 0)      # back
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], 0)      # left
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], 0)      # right
    add_quad([0.35, 0.999, 0.35], [0.65, 0.999, 0.35], [0.65, 0.999, 0.65],
             [0.35, 0.999, 0.65], 2, radiance=[40.0, 40.0, 40.0])   # light
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int32)
    sv, sf, _, _ = shapes.sphere(center=(0.5, 0.45, 0.5), radius=0.22, rings=16, segments=24)
    scene = ir.build_scene(np.concatenate([v, sv]), np.concatenate([f, sf + len(v)]),
                           np.asarray(tri_mat + [1] * len(sf), np.int32), mats,
                           tri_radiance=tri_rad, device=dev)
    cam = sensor.make_camera(origin=[0.5, 0.5, -1.4], target=[0.5, 0.5, 0.5], fov_x=39.3077,
                             width=width, height=width, device=dev)
    return scene, cam


def phase_mlt_glass(dev):
    """[mlt_glass]: the glass-sphere box at MLT_GLASS_WIDTH^2, depth 5,
    six kernels over MLT_GLASS_MUTATIONS mutations: two-vertex refraction
    chains (enter and exit) through F; the mean within 15% of path.li's
    (tests/test_mlt_manifold.py:79-83). Returns B1's launches by path."""
    scene, cam = glass_box(MLT_GLASS_WIDTH, dev)
    return mlt_cell("mlt_glass", scene, cam, dev, MLT_GLASS_MUTATIONS, MLT_GLASS_DEPTH,
                    MLT_GLASS_RTOL, 6)


def phase_cli_mlt(dev):
    """[cli_mlt]: [cli_cornell]'s scene files with --integrator mlt -s 16 (64
    mutations, the JAX defaults' chains and bootstrap paths) by the real
    command as a subprocess, its mean within [mlt]'s 6% of path.li's render
    of the loaded scene. [cli_mlt_daylight]: a sunsky scene file with
    --integrator mlt by cli.main in process (B1's launches counted and
    twin checked): the JAX CLI's route for a scene with an environment,
    pssmlt, printed. Returns B1's launches by path."""
    import tempfile

    from mitsuba_tpu_torch.integrators import common, mlt, path, pssmlt
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import xml

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path = cli_cornell_files(tmp, dev)[0]
        loaded, lcam, lcfg, _ = xml.load_xml(xml_path, device=dev)
        ref = float(common.render(loaded, lcam, path.li, lcfg).mean())
        wall = run_cli_subprocess(xml_path, tmp / "mlt.exr",
                                  ["-s", str(MLT_CLI_SPP), "--integrator", "mlt"])
        got = image.read_exr(tmp / "mlt.exr")
        mean = float(got.mean())
        say("cli_mlt", resolution=f"{lcam.width}x{lcam.height}", spp=MLT_CLI_SPP,
            mutations=max(MLT_CLI_SPP, 64), subprocess_wall_s=round(wall, 3),
            mean_radiance=round(mean, 6), path_mean=round(ref, 6),
            rel_to_path=round(abs(mean - ref) / ref, 5), bar=MLT_RTOL)
        if not (np.isfinite(got).all() and abs(mean - ref) <= MLT_RTOL * ref):
            raise AssertionError(f"cli_mlt: mean {mean} against path's {ref}")

        day = tmp / "daylight.xml"
        day.write_text(daylight_xml(MLT_CLI_DAYLIGHT_WIDTH, MLT_CLI_SPP, IRAWAN_DEPTH,
                                    GROUND_XML + CUBE_XML))
        routes = []

        def route(name, fn):
            def call(*args, **kw):
                routes.append(name)
                return fn(*args, **kw)
            return call

        with mock.patch.object(mlt, "render_jit", route("mlt", mlt.render_jit)), \
                mock.patch.object(pssmlt, "render_jit", route("pssmlt", pssmlt.render_jit)):
            launches, checked, times = run_cli_counted(
                bk, [day, "-o", tmp / "day.exr", "--integrator", "mlt"], dev)
        got = image.read_exr(tmp / "day.exr")
        say("cli_mlt_daylight", resolution=f"{MLT_CLI_DAYLIGHT_WIDTH}x{MLT_CLI_DAYLIGHT_WIDTH}",
            spp=MLT_CLI_SPP, route=routes, **times, b1_launches=launches,
            twin_checked_rays=checked, twin_mismatches=0,
            mean_radiance=round(float(got.mean()), 6))
        if routes != ["pssmlt"] or not (np.isfinite(got).all() and got.mean() > 0):
            raise AssertionError(f"cli_mlt_daylight: route {routes}, mean {got.mean()}")
        out.update(path_launches("cli_mlt_daylight", launches))
    return out


def kdbench_counted(mod, argv, dev):
    """mtsutil's kdbench in process with `mod`'s closest-hit launches
    counted from zero and the first launch per batch size rerun through
    the plain twin. Returns (its result, launches, twin-checked sizes)."""
    import torch

    from mitsuba_tpu_torch import mtsutil
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk

    for counts in (bk, bvk):
        counts.reset_counts()
    keeping, kept = keeping_launches(mod)
    with keeping:
        res = mtsutil.tool_kdbench([str(a) for a in argv])
    torch.cuda.synchronize(dev)
    launches, plain = dict(mod.KERNEL_LAUNCHES), {**bk.PLAIN_CALLS, **bvk.PLAIN_CALLS}
    other = bvk if mod is bk else bk
    if launches["closest"] == 0 or any(plain.values()) or any(other.KERNEL_LAUNCHES.values()):
        raise AssertionError(f"kdbench {argv}: launches {launches}, plain {plain}, other "
                             f"{other.KERNEL_LAUNCHES}")
    return res, launches, check_kept(mod, kept, entries=["closest_key"])


def phase_kdbench(dev):
    """[kdbench]: `python -m mitsuba_tpu_torch.mtsutil kdbench` (2^20 rays,
    the tool's default) on the built-in Cornell box, by the real command
    and in process (B1's launches counted and twin checked), then in
    process on the 70,034-triangle OBJ pair of [cli_mesh]'s scene file
    (the tool attaches the BVH: B2). Prints rays/s and the share of rays
    that hit (the protocol's rays run tangent to the bounding sphere, so
    most miss a round object). Returns the launches by path."""
    import os
    import tempfile

    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.scene import builtin

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mitsuba_tpu_torch.mtsutil", "kdbench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0 or "M rays/s" not in res.stdout:
        raise AssertionError(f"mtsutil kdbench exited {res.returncode}:\n{res.stderr[-4000:]}")
    say("kdbench_command", line=res.stdout.strip(), subprocess_wall_s=round(wall, 3))
    out = {}
    bench, launches, checked = kdbench_counted(bk, [], dev)
    say("kdbench_cornell", tris=bench["triangles"], rays=bench["rays"],
        rays_per_s=round(bench["rays_per_s"]), ms_per_batch=round(bench["ms_per_batch"], 4),
        hit_share=round(bench["hit_share"], 4),
        b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0)
    out.update(path_launches("kdbench_cornell", launches))
    scene, cam = builtin.displaced_sphere(width=CLI_MESH_WIDTH, height=CLI_MESH_WIDTH,
                                          device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        xml_path, groups = write_scene_files(
            tmp, scene, '<sensor type="perspective"/>', '<integrator type="path"/>')
        bench, launches, checked = kdbench_counted(bvk, [xml_path], dev)
    say("kdbench_mesh", tris=bench["triangles"], obj_files=len(groups), rays=bench["rays"],
        rays_per_s=round(bench["rays_per_s"]), ms_per_batch=round(bench["ms_per_batch"], 4),
        hit_share=round(bench["hit_share"], 4),
        bvh_launches=launches, twin_checked_rays=checked, twin_mismatches=0)
    if bench["triangles"] != scene.num_triangles:
        raise AssertionError(f"kdbench_mesh: {bench['triangles']} triangles")
    out.update(path_launches("kdbench_mesh", launches, "bvh"))
    return out


def dae_text(parts):
    """A COLLADA 1.4 document (Y_UP) with one <geometry> per (name,
    positions (V,3), triangles (T,3)) part, as <triangles> of VERTEX
    indices, each instanced by a node without transforms."""
    geoms, nodes = [], []
    for name, pos, tris in parts:
        floats = " ".join(repr(float(x)) for x in pos.ravel())
        idx = " ".join(str(int(i)) for i in tris.ravel())
        geoms.append(
            f'<geometry id="{name}" name="{name}"><mesh><source id="{name}-pos">'
            f'<float_array id="{name}-arr" count="{pos.size}">{floats}</float_array>'
            f'<technique_common><accessor source="#{name}-arr" count="{len(pos)}" stride="3"/>'
            f'</technique_common></source><vertices id="{name}-v"><input semantic="POSITION" '
            f'source="#{name}-pos"/></vertices><triangles count="{len(tris)}"><input '
            f'semantic="VERTEX" source="#{name}-v" offset="0"/><p>{idx}</p></triangles>'
            f'</mesh></geometry>')
        nodes.append(f'<node id="n-{name}"><instance_geometry url="#{name}"/></node>')
    return ('<?xml version="1.0" encoding="utf-8"?>\n<COLLADA xmlns="http://www.collada.org/'
            '2005/11/COLLADASchema" version="1.4.1"><asset><up_axis>Y_UP</up_axis></asset>'
            f'<library_geometries>{"".join(geoms)}</library_geometries><library_visual_scenes>'
            f'<visual_scene id="s">{"".join(nodes)}</visual_scene></library_visual_scenes>'
            '</COLLADA>\n')


def phase_mtsimport(dev):
    """[mtsimport]: a .dae written here (a 32x64 sphere and a ground quad in
    front of the default sensor) through `python -m
    mitsuba_tpu_torch.mtsutil mtsimport`; the scene file it writes loads
    through load_xml on the card with the .dae's triangle count and its
    vertices (as a set: the importer de-indexes them) bit for bit, and
    renders at MTSIMPORT_WIDTH^2 x 16 spp under its constant light through
    path.li on B1 (counted and twin checked), finite and lit. Returns B1's
    launches by path."""
    import dataclasses
    import os
    import tempfile

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import shapes, xml

    sv, sf, _, _ = shapes.sphere(center=(0.0, 0.0, 4.0), radius=1.0, rings=32, segments=64)
    qv = np.asarray([[-3, -1, 1], [3, -1, 1], [3, -1, 8], [-3, -1, 8]], np.float32)
    qf = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    parts = (("sphere", sv.astype(np.float32), sf), ("ground", qv, qf))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "model.dae").write_text(dae_text(parts))
        res = subprocess.run([sys.executable, "-m", "mitsuba_tpu_torch.mtsutil", "mtsimport",
                              str(tmp / "model.dae"), str(tmp / "scene.xml")], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        if res.returncode != 0:
            raise AssertionError(f"mtsimport exited {res.returncode}:\n{res.stderr[-4000:]}")
        scene, cam, cfg, integ = xml.load_xml(tmp / "scene.xml", device=dev)
    want_tris = sum(len(p[2]) for p in parts)
    used = np.concatenate([p[1][np.unique(p[2])] for p in parts])
    got = scene.vertices.cpu().numpy()
    same = (scene.num_triangles == want_tris and got.shape == used.shape
            and np.array_equal(np.unique(got, axis=0), np.unique(used, axis=0)))
    cam = cam.replace(width=MTSIMPORT_WIDTH, height=MTSIMPORT_WIDTH)
    keeping, read = counted()
    with keeping:
        img, render_s = timed(lambda: common.render(scene, cam, path.li,
                                                    dataclasses.replace(cfg, spp=16)), dev)
    launches, plain, kept = read()
    require_b1("mtsimport", launches, plain)
    checked = check_kept(bk, kept)
    say("mtsimport", line=res.stdout.strip(), integrator=integ, tris=scene.num_triangles,
        dae_tris=want_tris, vertices_equal=same, resolution=f"{cam.width}x{cam.height}", spp=16,
        render_s=round(render_s, 4), mean_radiance=round(float(img.mean()), 6),
        b1_launches=launches, twin_checked_rays=checked, twin_mismatches=0)
    require_finite("mtsimport", img, (MTSIMPORT_WIDTH, MTSIMPORT_WIDTH, 3))
    if not (same and float(img.mean()) > 0.05):
        raise AssertionError(f"mtsimport: load equal {same}, mean {float(img.mean())}")
    return path_launches("mtsimport", launches)


MLT_PHASES = (phase_manifold_walk, phase_mlt, phase_mlt_caustic, phase_mlt_glass, phase_cli_mlt,
              phase_kdbench, phase_mtsimport)


# --- sharded and multi-process rendering, subsurface, chi-square, native -------

PARALLEL_WIDTH = 256
SHARDED_SPP = 16                 # the Cornell headline's width at 16 spp, depth 8
SHARDED_DEPTH = 8
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-5   # tests/test_sharded.py
TRAIN_SPP, TRAIN_DEPTH, TRAIN_STEPS = 4, 3, 3   # tests/test_sharded.py:45-66 at full width
TRAIN_LR, TRAIN_TARGET = 0.1, 0.05
DIST_CLI_TOL = 1e-4              # tests/test_torch_cli.py's RENDER_TOL
SSS_POINTS = 4096
SSS_IRRADIANCE_SAMPLES = 8
SSS_SINGLE_SAMPLES = 4
SSS_TWIN_POINTS = 1024
SSS_SLAB_SAMPLES = 32
SSS_RATIO = (0.3, 3.0)           # tests/test_subsurface.py:178
CHI2_SAMPLES = 1 << 20
WARP_SIGNIFICANCE = 0.0025       # spherical_chi2's default (tests/test_warp.py)
BSDF_SIGNIFICANCE = 0.001        # tests/test_bsdf.py:80
CHI2_MASS_TOL = 2e-2             # tests/test_warp.py:18


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def world_one_group():
    """A one-rank process group in this process (NCCL: the rank has its
    card); yields its backend and leaves the group on exit."""
    import torch.distributed as dist

    from mitsuba_tpu_torch.parallel import render_sharded as rs

    _, backend = rs.start_group(f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    try:
        yield backend
    finally:
        dist.destroy_process_group()


def require_equal_images(what, img, ref, rtol, atol):
    """img against ref at (rtol, atol); returns the largest difference."""
    import torch

    diff = float((img - ref).abs().max())
    if img.shape != ref.shape or not torch.allclose(img, ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max diff {diff} against the one-device render")
    return diff


def phase_sharded(dev):
    """[sharded]: the Cornell box at PARALLEL_WIDTH^2 x SHARDED_SPP, depth
    SHARDED_DEPTH, through render_sharded at mesh (1, 1) on a one-rank NCCL
    group in process, then [sharded_gaussian] with the Gaussian filter
    (the full-film path); [sharded_mesh]: the 70,034-triangle displaced
    sphere at CLI_MESH_WIDTH^2 x 16 spp (B2). Each counted like a
    bidir_cell, its image equal to common.render's of the same config at
    tests/test_sharded.py's bar. [sharded_train]: TRAIN_STEPS steps of
    train_step on the Cornell box at PARALLEL_WIDTH^2 x TRAIN_SPP, depth
    TRAIN_DEPTH (every float leaf of the scene): the loss falls, every
    update is finite; then one more step profiled (its busy share).
    Returns the launches by path."""
    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.parallel import render_sharded as rs
    from mitsuba_tpu_torch.scene import builtin

    out = {}
    with world_one_group() as backend:
        mesh = rs.make_mesh(1, sp=1)
        scene, cam = builtin.cornell_box(PARALLEL_WIDTH, PARALLEL_WIDTH, device=dev)
        for name, filt in (("sharded", film.FILTER_BOX), ("sharded_gaussian",
                                                           film.FILTER_GAUSSIAN)):
            cfg = common.RenderConfig(spp=SHARDED_SPP, max_depth=SHARDED_DEPTH, rr_depth=5,
                                      seed=0, filter=filt)
            ref = common.render(scene, cam, path.li, cfg)
            img, launches = bidir_cell(
                name, lambda c: rs.render_sharded(scene, cam, path.li, c, mesh), cfg, dev,
                scene, cam, backend=backend, mesh="(1, 1)", filter=film.FILTER_NAMES[filt])
            diff = require_equal_images(name, img, ref, SHARDED_RTOL, SHARDED_ATOL)
            say(f"{name}_check", max_abs_diff=diff, bar=[SHARDED_RTOL, SHARDED_ATOL])
            out.update(launches)

        mscene, mcam = builtin.displaced_sphere(width=CLI_MESH_WIDTH, height=CLI_MESH_WIDTH,
                                                device=dev)
        cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
        ref = common.render(mscene, mcam, path.li, cfg)
        img, launches = bidir_cell(
            "sharded_mesh", lambda c: rs.render_sharded(mscene, mcam, path.li, c, mesh), cfg,
            dev, mscene, mcam, kernel="b2", backend=backend, mesh="(1, 1)")
        diff = require_equal_images("sharded_mesh", img, ref, SHARDED_RTOL, SHARDED_ATOL)
        say("sharded_mesh_check", max_abs_diff=diff, bar=[SHARDED_RTOL, SHARDED_ATOL])
        out.update(launches)
        out.update(train_cell(scene, cam, mesh, backend, dev))
    return out


def train_cell(scene, cam, mesh, backend, dev):
    """[sharded_train] (phase_sharded): TRAIN_STEPS train_step calls with
    B1 counted and twin checked, the losses, each step's seconds, the
    update's finiteness and step_peak_gb; then one more step profiled."""
    import torch

    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.parallel import render_sharded as rs

    cfg = common.RenderConfig(spp=TRAIN_SPP, max_depth=TRAIN_DEPTH, rr_depth=5, seed=1)
    target = torch.full((cam.height, cam.width, 3), TRAIN_TARGET, device=dev)
    keeping, read = counted()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    s, losses, step_s, finite = scene, [], [], True
    with keeping:
        for _ in range(TRAIN_STEPS):
            (s_new, loss), sec = timed(
                lambda: rs.train_step(s, cam, target, path.li, cfg, mesh, lr=TRAIN_LR), dev)
            finite &= all(bool(torch.isfinite(v).all()) for _, v in rs._float_leaves(s_new))
            s = s_new
            losses.append(float(loss))
            step_s.append(round(sec, 4))
    step_peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    launches, plain, kept = read()
    require_b1("sharded_train", launches, plain)
    checked = check_kept(bk, kept)
    moved = [".".join(p) for (p, a), (_, b) in zip(rs._float_leaves(scene), rs._float_leaves(s))
             if not torch.equal(a, b)]
    say("sharded_train", resolution=f"{cam.width}x{cam.height}", spp=TRAIN_SPP,
        max_depth=TRAIN_DEPTH, steps=TRAIN_STEPS, lr=TRAIN_LR, backend=backend,
        step_s=step_s, losses=[round(x, 6) for x in losses], leaves_moved=moved,
        updates_finite=finite, step_peak_gb=round(step_peak_gb, 3), b1_launches=launches,
        twin_checked_rays=checked, twin_mismatches=0)
    if not (finite and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"sharded_train: losses {losses}, updates finite {finite}")
    profile_call("sharded_train", lambda: rs.train_step(s, cam, target, path.li, cfg, mesh,
                                                        lr=TRAIN_LR), dev,
                 resolution=f"{cam.width}x{cam.height}", spp=TRAIN_SPP)
    return path_launches("sharded_train", launches)


def phase_cli_distributed(dev):
    """[cli_distributed]: [cli_cornell]'s scene file through two processes
    of `python -m mitsuba_tpu_torch <file> --distributed 127.0.0.1:P,2,I
    --mesh 2,1` sharing the card (gloo), rank 0's EXR against the
    one-process CLI image (cli.main in process) within DIST_CLI_TOL, rank 1
    writing nothing; then `--mesh 1,1` (a one-rank NCCL group, no ranks to
    spawn) in process through run_cli_counted, so that its B1 launches are
    counted from zero and twin checked. Each run's backend (as its ranks
    print it), seconds and mean. Returns B1's launches of the --mesh 1,1
    run as {path: launches}."""
    import io
    import os
    import tempfile

    from mitsuba_tpu_torch import cli
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.ops import brute_kernel as bk

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        xml_path = cli_cornell_files(tmp, dev)[0]
        t0 = time.perf_counter()
        if cli.main([str(xml_path), "-o", str(tmp / "one.exr"), "-q"]) != 0:
            raise AssertionError("cli_distributed: the one-process render failed")
        one_s = time.perf_counter() - t0
        one = image.read_exr(tmp / "one.exr")

        def command(out, *extra):
            return [sys.executable, "-m", "mitsuba_tpu_torch", str(xml_path), "-o", str(out),
                    "-q", *extra]

        runs = {}
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(command(tmp / f"rank{i}.exr", "--mesh", "2,1",
                                          "--distributed", f"127.0.0.1:{port},2,{i}"),
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for i in range(2)]
        errs = [proc.communicate(timeout=CLI_TIMEOUT_S)[1] for proc in procs]
        for proc, err in zip(procs, errs):
            if proc.returncode != 0:
                raise AssertionError(f"cli_distributed distributed_2x1 exited "
                                     f"{proc.returncode}:\n{err[-4000:]}")
        runs["distributed_2x1"] = (time.perf_counter() - t0, errs, tmp / "rank0.exr")
        if (tmp / "rank1.exr").exists():
            raise AssertionError("cli_distributed: rank 1 wrote an image")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            launches, checked, times = run_cli_counted(
                bk, [xml_path, "-o", tmp / "mesh11.exr", "--mesh", "1,1"], dev)
        runs["mesh_1x1"] = (time.perf_counter() - t0, [err.getvalue()], tmp / "mesh11.exr")
        sys.stderr.write(err.getvalue())
        lines = {}
        for name, (sec, es, out) in runs.items():
            backends = [ln.split("backend ")[1].split(",")[0] for e in es
                        for ln in e.splitlines() if "backend " in ln]
            img = image.read_exr(out)
            diff = float(np.abs(img - one).max())
            lines[name] = dict(seconds=round(sec, 3), backends=backends,
                               mean_radiance=round(float(img.mean()), 6), max_abs_diff=diff)
            if not np.allclose(img, one, rtol=DIST_CLI_TOL, atol=DIST_CLI_TOL):
                raise AssertionError(f"cli_distributed {name}: max diff {diff} against the "
                                     "one-process image")
        want = {"distributed_2x1": ["gloo", "gloo"], "mesh_1x1": ["nccl"]}
        if any(sorted(lines[k]["backends"]) != v for k, v in want.items()):
            raise AssertionError(f"cli_distributed: backends {lines}")
        lines["mesh_1x1"].update(**times, b1_launches=launches, twin_checked_rays=checked,
                                 twin_mismatches=0)
    say("cli_distributed", resolution=f"{CLI_CORNELL_WIDTH}x{CLI_CORNELL_WIDTH}",
        spp=FRONTEND_SPP, one_process_s=round(one_s, 3),
        one_process_mean=round(float(one.mean()), 6), **lines, bar=DIST_CLI_TOL)
    return path_launches("cli_mesh_1x1", launches)


def dipole_params(dev):
    """tests/test_subsurface.py's params(sigma_t=30): albedo 0.8, eta 1.3."""
    import torch

    from mitsuba_tpu_torch.models import subsurface as sss

    return sss.DipoleParams(sigma_s=torch.full((3,), 24.0, device=dev),
                            sigma_a=torch.full((3,), 6.0, device=dev), g=0.0, eta=1.3)


def first_hits(scene, cam):
    """Hit points, shading normals facing the camera and wo of every pixel
    centre's camera ray that hits."""
    import torch

    from mitsuba_tpu_torch.models import sensor
    from mitsuba_tpu_torch.ops import intersect, trace

    w, h = cam.width, cam.height
    ys, xs = torch.meshgrid(torch.arange(h, device=scene.device),
                            torch.arange(w, device=scene.device), indexing="ij")
    n = w * h
    o, d, _ = sensor.sample_rays(cam, xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5,
                                 torch.full((n, 2), 0.5, device=scene.device))
    its = trace.closest_hit(scene, o, d)
    si = intersect.surface_interaction(scene, o, d, its)
    ns = si["ns"] * torch.where((si["ns"] * d).sum(-1, keepdim=True) > 0, -1.0, 1.0)
    ok = its.valid
    return si["p"][ok], ns[ok], -d[ok]


def slab_scene(dev):
    """tests/test_subsurface.py:143-178's flat slab: a 2x2 floor under a
    0.6x0.6 area light of radiance 10 at height 1."""
    from mitsuba_tpu_torch.scene import ir

    verts = np.asarray([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-0.3, 1.0, -0.3],
                        [0.3, 1.0, -0.3], [0.3, 1.0, 0.3], [-0.3, 1.0, 0.3]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    return ir.build_scene(verts, tris, np.zeros(4, np.int32), [{"type": ir.BSDF_DIFFUSE}],
                          tri_radiance={2: [10.0] * 3, 3: [10.0] * 3}, device=dev)


def slab_ratio(dev):
    """The exact / classical single-scatter mean on the slab fixture (64
    queries across the floor, SSS_SLAB_SAMPLES samples, seed 3)."""
    import torch

    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.models import subsurface as sss

    scene = slab_scene(dev)
    p = sss.DipoleParams(sigma_s=torch.full((3,), 2.0, device=dev),
                         sigma_a=torch.full((3,), 0.2, device=dev), eta=1.4, g=0.0)
    n = 64
    qp = torch.stack([torch.linspace(-0.4, 0.4, n), torch.zeros(n), torch.zeros(n)], -1).to(dev)
    ns = torch.tensor([[0.0, 1.0, 0.0]], device=dev).repeat(n, 1)
    cfg = common.RenderConfig(spp=1, seed=3)
    le, lc = (sss.single_scatter_radiance(p, scene, qp, ns, ns, cfg, n_samples=SSS_SLAB_SAMPLES,
                                          exact_nee=exact) for exact in (True, False))
    require_finite("slab exact", le, (n, 3))
    return float(le.mean()) / float(lc.mean())


def phase_subsurface(dev):
    """[subsurface]: the dipole on the Cornell box's short block
    (tests/test_subsurface.py:44-45's triangles): SSS_POINTS blue-noise
    cache points (host darts), their irradiance with SSS_IRRADIANCE_SAMPLES
    NEE samples, the dipole gather at the first hits of a PARALLEL_WIDTH^2
    camera and single_scatter_radiance (SSS_SINGLE_SAMPLES samples, exact
    NEE) there, with B1 counted and twin checked; all finite and
    non-negative; the slab fixture's exact/classical ratio within SSS_RATIO;
    on SSS_TWIN_POINTS of the queries the card against the CPU (the largest
    gap relative to the largest value); the busy share of the irradiance,
    gather and single-scatter passes profiled once more. Returns B1's
    launches by path."""
    import torch

    from mitsuba_tpu_torch.integrators import common
    from mitsuba_tpu_torch.models import subsurface as sss
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(PARALLEL_WIDTH, PARALLEL_WIDTH, device=dev)
    mask = np.zeros(scene.num_triangles, bool)
    mask[SHORT_BLOCK_TRIS] = True
    t0 = time.perf_counter()
    pts, nrm, area = sss.sample_surface_points(scene, mask, SSS_POINTS)
    darts_s = time.perf_counter() - t0
    cfg = common.RenderConfig(seed=1)
    p = dipole_params(dev)
    keeping, read = counted()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with keeping:
        E, irr_s = timed(lambda: sss.compute_irradiance(scene, pts, nrm, cfg,
                                                        n_samples=SSS_IRRADIANCE_SAMPLES), dev)
        (q, qn, wo), hits_s = timed(lambda: first_hits(scene, cam), dev)
        lo, gather_s = timed(lambda: sss.sss_exitant_radiance(p, pts, E, area, q, qn, wo), dev)
        ls, single_s = timed(lambda: sss.single_scatter_radiance(
            p, scene, q, qn, wo, cfg, n_samples=SSS_SINGLE_SAMPLES, exact_nee=True), dev)
    step_peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    launches, plain, kept = read()
    require_b1("subsurface", launches, plain)
    checked = check_kept(bk, kept)
    ratio = slab_ratio(dev)

    # the card against the CPU on the first SSS_TWIN_POINTS queries
    k = SSS_TWIN_POINTS
    cpu_scene, _ = builtin.cornell_box(PARALLEL_WIDTH, PARALLEL_WIDTH, device="cpu")
    pc = dipole_params("cpu")
    E_cpu = sss.compute_irradiance(cpu_scene, pts.cpu(), nrm.cpu(), cfg,
                                   n_samples=SSS_IRRADIANCE_SAMPLES)
    lo_cpu = sss.sss_exitant_radiance(pc, pts.cpu(), E.cpu(), area, q[:k].cpu(), qn[:k].cpu(),
                                      wo[:k].cpu())
    ls_cpu = sss.single_scatter_radiance(pc, cpu_scene, q[:k].cpu(), qn[:k].cpu(),
                                         wo[:k].cpu(), cfg, n_samples=SSS_SINGLE_SAMPLES,
                                         exact_nee=True)

    def gap(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))

    gaps = {"irradiance": gap(E, E_cpu), "gather": gap(lo[:k], lo_cpu),
            "single_scatter": gap(ls[:k], ls_cpu)}
    say("subsurface", cache_points=pts.shape[0], darts_s=round(darts_s, 3),
        irradiance_samples=SSS_IRRADIANCE_SAMPLES, irradiance_s=round(irr_s, 4),
        queries=q.shape[0], first_hits_s=round(hits_s, 4), gather_s=round(gather_s, 4),
        gather_pairs=q.shape[0] * pts.shape[0], single_samples=SSS_SINGLE_SAMPLES,
        single_scatter_s=round(single_s, 4), step_peak_gb=round(step_peak_gb, 3),
        mean_E=round(float(E.mean()), 6), mean_dipole=round(float(lo.mean()), 6),
        mean_single=round(float(ls.mean()), 6), slab_ratio=round(ratio, 4), ratio_bar=SSS_RATIO,
        card_cpu_rel_gap=gaps, b1_launches=launches, twin_checked_rays=checked,
        twin_mismatches=0)
    for name, x in (("irradiance", E), ("dipole", lo), ("single scatter", ls)):
        if not (bool(torch.isfinite(x).all()) and float(x.min()) >= 0):
            raise AssertionError(f"subsurface {name}: finite {bool(torch.isfinite(x).all())}, "
                                 f"min {float(x.min())}")
    if not (float(lo.max()) > 0 and float(ls.max()) > 0
            and SSS_RATIO[0] < ratio < SSS_RATIO[1]):
        raise AssertionError(f"subsurface: dipole max {float(lo.max())}, single max "
                             f"{float(ls.max())}, slab ratio {ratio}")
    profile_call("subsurface", lambda: (
        sss.compute_irradiance(scene, pts, nrm, cfg, n_samples=SSS_IRRADIANCE_SAMPLES),
        sss.sss_exitant_radiance(p, pts, E, area, q, qn, wo),
        sss.single_scatter_radiance(p, scene, q, qn, wo, cfg, n_samples=SSS_SINGLE_SAMPLES,
                                    exact_nee=True)), dev, queries=q.shape[0])
    return path_launches("subsurface", launches)


def lifted(warp_2d, pdf_2d):
    """A planar warp onto the upper hemisphere through the gnomonic map
    d = (x, y, 1) / |(x, y, 1)|, with its solid-angle pdf pdf_2d(x, y) /
    cos^3(theta): (sample_fn, pdf_fn) for spherical_chi2."""
    import torch

    def sample(u):
        xy = warp_2d(u)
        return torch.nn.functional.normalize(
            torch.cat([xy, torch.ones_like(xy[:, :1])], -1), dim=-1)

    def pdf(v):
        z = v[:, 2]
        zs = torch.where(z > 1e-6, z, 1.0)
        return torch.where(z > 1e-6, pdf_2d(v[:, 0] / zs, v[:, 1] / zs) / zs ** 3, 0.0)

    return sample, pdf


def chi2_warp_cases():
    """{name: (sample_fn, pdf_fn)}: the eight warps the port gained, at
    tests/test_warp.py's parameters. The uniform disk is lifted to the
    hemisphere by Malley's method (its pdf cos/pi); the standard normal and
    the tent through the gnomonic map (lifted)."""
    import math

    import torch

    from mitsuba_tpu_torch.core import warp

    def malley(u):
        xy = warp.square_to_uniform_disk(u)
        return torch.cat([xy, torch.sqrt(torch.clamp_min(1 - (xy * xy).sum(-1, keepdim=True),
                                                         0.0))], -1)

    def tent_1d(t):
        return torch.clamp_min(1.0 - torch.abs(t), 0.0)

    cases = {
        "uniform_hemisphere": (warp.square_to_uniform_hemisphere, lambda v: torch.where(
            v[..., 2] >= 0, warp.square_to_uniform_hemisphere_pdf(), 0.0)),
        "uniform_disk": (malley, warp.square_to_cosine_hemisphere_pdf),
        "std_normal": lifted(warp.square_to_std_normal, lambda x, y: torch.exp(
            -0.5 * (x * x + y * y)) / (2 * math.pi)),
        "tent": lifted(warp.square_to_tent, lambda x, y: tent_1d(x) * tent_1d(y)),
        "vmf": (lambda u: warp.square_to_von_mises_fisher(u, 8.0),
                lambda v: warp.square_to_von_mises_fisher_pdf(v, 8.0)),
        "phong_lobe": (lambda u: warp.square_to_phong_lobe(u, 12.0),
                       lambda v: warp.square_to_phong_lobe_pdf(v, 12.0)),
    }
    for alpha in (0.1, 0.4):
        cases[f"beckmann_{alpha}"] = (lambda u, a=alpha: warp.square_to_beckmann(u, a),
                                      lambda v, a=alpha: warp.square_to_beckmann_pdf(v, a))
        cases[f"ggx_{alpha}"] = (lambda u, a=alpha: warp.square_to_ggx(u, a),
                                 lambda v, a=alpha: warp.square_to_ggx_pdf(v, a))
    return cases


# tests/test_bsdf.py:28-51's records
BSDF_CHI2_CASES = {
    "diffuse": {"type": "BSDF_DIFFUSE", "reflectance": [0.8, 0.8, 0.8]},
    "rough_conductor_ggx": {"type": "BSDF_ROUGH_CONDUCTOR", "alpha": [0.3, 0.3],
                            "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14],
                            "extra": [0, 0, 0, "MICROFACET_GGX"]},
    "rough_conductor_beckmann": {"type": "BSDF_ROUGH_CONDUCTOR", "alpha": [0.25, 0.25],
                                 "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14],
                                 "extra": [0, 0, 0, "MICROFACET_BECKMANN"]},
    "plastic": {"type": "BSDF_PLASTIC", "reflectance": [0.5, 0.2, 0.1]},
    "phong": {"type": "BSDF_PHONG", "reflectance": [0.4, 0.4, 0.4],
              "specular": [0.3, 0.3, 0.3], "extra": [30.0, 0, 0, 0]},
    "rough_diffuse": {"type": "BSDF_ROUGH_DIFFUSE", "reflectance": [0.7, 0.7, 0.7],
                      "alpha": [0.3, 0.3]},
    "rough_plastic": {"type": "BSDF_ROUGH_PLASTIC", "reflectance": [0.5, 0.3, 0.2],
                      "alpha": [0.3, 0.3], "extra": [0, 0, 0, "MICROFACET_GGX"]},
    "rough_dielectric": {"type": "BSDF_ROUGH_DIELECTRIC", "eta": [1.5, 1.5, 1.5],
                         "alpha": [0.3, 0.3], "reflectance": [1, 1, 1], "specular": [1, 1, 1],
                         "extra": [0, 0, 0, "MICROFACET_GGX"]},
}


def bsdf_chi2_case(rec, n, dev):
    """(sample_fn, pdf_fn, weights of the last sample call) of one
    tests/test_bsdf.py record: wi = normalize(0.3, -0.2, 0.8), u_lobe the
    JAX test's jax.random.uniform(PRNGKey(99)) draws, rejected and delta
    lanes weighted 0 (the test's retry with sample_weights)."""
    import torch

    from mitsuba_tpu_torch.core import math as m, rng
    from mitsuba_tpu_torch.models import bsdf
    from mitsuba_tpu_torch.scene import ir

    rec = {k: ([getattr(ir, x) if isinstance(x, str) else x for x in v] if isinstance(v, list)
               else getattr(ir, v) if isinstance(v, str) else v) for k, v in rec.items()}
    fam = (rec["type"],)
    mats = ir.Materials.stack([rec], dev)
    wi0 = m.normalize(torch.tensor([0.3, -0.2, 0.8], device=dev))

    def sp(k):
        return bsdf.ShadePoint(*(getattr(mats, f)[0].expand(k, *getattr(mats, f).shape[1:])
                                 for f in ("type", "reflectance", "specular", "eta", "k",
                                           "alpha", "extra")))

    u_lobe = torch.from_numpy(rng.threefry_uniform(rng.threefry_key(99), (n,))).to(dev)
    weights = {}

    def sample(u2):
        wo, _, pdf, is_delta = bsdf.sample(sp(u2.shape[0]), wi0.expand(u2.shape[0], 3),
                                           u_lobe, u2, fam)
        weights["w"] = ((pdf > 0) & ~is_delta).to(torch.float64)
        return wo

    def pdf(v):
        return bsdf.eval_pdf(sp(v.shape[0]), wi0.expand(v.shape[0], 3), v, fam)[1]

    return sample, pdf, weights


def phase_chi2_warps(dev):
    """[chi2_warps]: spherical_chi2 on the card at CHI2_SAMPLES samples for
    the eight warps the port gained (chi2_warp_cases, at
    WARP_SIGNIFICANCE, the mass within CHI2_MASS_TOL of the accepted
    share), then [chi2_bsdf]: the BSDF records of tests/test_bsdf.py:58-93
    (bsdf_chi2_case) at BSDF_SIGNIFICANCE. Each prints its p-value,
    statistic and seconds; any that fails raises."""
    import torch

    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.utils.chi2 import spherical_chi2

    def run(group, cases, significance):
        results, failed = {}, []
        for name, (sample, pdf, weights) in cases.items():
            t0 = time.perf_counter()
            if weights is None:
                passed, p, st = spherical_chi2(sample, pdf, n_samples=CHI2_SAMPLES,
                                               significance=significance, device=dev)
            else:
                # the weights of the harness's own draws (seed 3), as the JAX test's retry
                sample(torch.from_numpy(rng.threefry_uniform(rng.threefry_key(3),
                                                             (CHI2_SAMPLES, 2))).to(dev))
                passed, p, st = spherical_chi2(sample, pdf, n_samples=CHI2_SAMPLES, seed=3,
                                               significance=significance,
                                               sample_weights=weights["w"], device=dev)
            mass_ok = abs(st["pdf_mass"] - st["accept_frac"]) < CHI2_MASS_TOL
            results[name] = {"p": float(f"{p:.6g}"), "chi2": round(st["chi2"], 2),
                             "dof": st["dof"], "mass": round(st["pdf_mass"], 5),
                             "accept": round(st["accept_frac"], 5),
                             "s": round(time.perf_counter() - t0, 3)}
            if not (passed and (weights is not None or mass_ok)):
                failed.append(name)
        say(group, samples=CHI2_SAMPLES, significance=significance, cases=results)
        if failed:
            raise AssertionError(f"{group}: {failed} failed")

    run("chi2_warps", {k: (s, p, None) for k, (s, p) in chi2_warp_cases().items()},
        WARP_SIGNIFICANCE)
    run("chi2_bsdf", {k: bsdf_chi2_case(rec, CHI2_SAMPLES, dev)
                      for k, rec in BSDF_CHI2_CASES.items()}, BSDF_SIGNIFICANCE)
    return {}


def phase_native(dev):
    """[native]: the native library builds from native/*.cpp; [cli_mesh]'s
    70,034-triangle OBJ pair parses through it and through the Python
    parser with equal arrays, and the BVH of the whole mesh builds through
    it and through numpy with equal arrays; each way's seconds (P7)."""
    import tempfile

    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.io import mesh
    from mitsuba_tpu_torch.scene import builtin, bvh

    if not native.available():
        raise AssertionError(f"native: the library does not build: {native.build_error()}")
    scene, _ = builtin.displaced_sphere(width=CLI_MESH_WIDTH, height=CLI_MESH_WIDTH,
                                        device=dev)
    times = {"native_parse_s": 0.0, "python_parse_s": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        _, groups = write_scene_files(tmp, scene, '<sensor type="perspective"/>',
                                      '<integrator type="path"/>')
        objs = sorted(Path(tmp).glob("g*.obj"))
        for obj in objs:
            t0 = time.perf_counter()
            nat = mesh.load_obj(obj)
            times["native_parse_s"] += time.perf_counter() - t0
            with mock.patch.object(native, "parse_obj", lambda path: None):
                t0 = time.perf_counter()
                py = mesh.load_obj(obj)
                times["python_parse_s"] += time.perf_counter() - t0
            for k in ("vertices", "indices", "normals", "uvs"):
                a, b = getattr(nat, k), getattr(py, k)
                if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                    raise AssertionError(f"native: {obj.name} {k} differs from the Python parse")
    verts = scene.vertices.cpu().numpy()
    tris = scene.indices.cpu().numpy()
    t0 = time.perf_counter()
    nat = bvh.build_bvh(verts, tris, device="cpu")
    times["native_bvh_s"] = time.perf_counter() - t0
    with mock.patch.object(native, "build_lbvh", lambda *a: None):
        t0 = time.perf_counter()
        py = bvh.build_bvh(verts, tris, device="cpu")
        times["python_bvh_s"] = time.perf_counter() - t0
    for k in ("aabb_min", "aabb_max", "miss_link", "tri_order"):
        if not np.array_equal(getattr(nat, k).numpy(), getattr(py, k).numpy()):
            raise AssertionError(f"native: the BVH's {k} differs from the numpy build's")
    say("native", library=native.build().name, obj_files=len(objs), tris=int(tris.shape[0]),
        arrays_equal=True, **{k: round(v, 4) for k, v in times.items()})
    return {}


PARALLEL_PHASES = (phase_sharded, phase_cli_distributed, phase_subsurface, phase_chi2_warps,
                   phase_native)



# The compiled renders (the [jit] group): common.render_jit and
# wavefront.render_jit, each render captured into CUDA graphs and replayed
# (utils/graphs.py), against the eager render of the same run. C31's bar
# where the film sums with atomics (the Gaussian splat, the compaction
# ladder's scatter); bit for bit elsewhere on common.render_jit; C8's bar
# on the wavefront against [headline] and [bigmesh].
JIT_PASSES, JIT_PASS_SPP = 4, 16
JIT_RTOL, JIT_ATOL = 1e-5, 1e-6
JIT_PROFILE_SPP = 4


def _kernel_counts():
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk

    return {**{f"brute_{k}": v for k, v in bk.KERNEL_LAUNCHES.items()},
            **{f"bvh_{k}": v for k, v in bvk.KERNEL_LAUNCHES.items()}}


def _reset_kernel_counts():
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk

    for counts in (bk, bvk):
        counts.reset_counts()


def jit_cell(name, eager, jit, dev, check, eager_out=None, profile=None, eager_s=None,
             eager_busy=None, captures_per_call=0, **fields):
    """[name]: `jit()` (a render through render_jit) against `eager()`, the
    eager render of the same configuration in this run, or `eager_out`,
    (image, launches) of an earlier phase's (`eager_s` its seconds). The
    first jit call captures; the second, timed with the kernels' launches
    counted from zero, only replays (or captures `captures_per_call`
    graphs: irrcache's Li is new each call). Its launches (counted per
    replay) must equal the eager render's entry for entry and launch some
    kernel; `check(img, ref)` raises where the images differ beyond the
    cell's bar and returns what the line prints. `profile`: (eager, jit)
    renders whose device busy shares are printed (eager None: the busy
    share `eager_busy` of an earlier phase's profile), each called once
    before (its capture). Returns {name: the replayed run's launches}."""
    from mitsuba_tpu_torch.ops import brute_kernel as bk
    from mitsuba_tpu_torch.ops import bvh_kernel as bvk
    from mitsuba_tpu_torch.utils import graphs

    if eager_out is None:
        _reset_kernel_counts()
        ref, eager_s = timed(eager, dev)
        eager_launches = _kernel_counts()
    else:
        ref, eager_launches = eager_out
    graphs.reset_counts()
    _, first_s = timed(jit, dev)
    first = dict(graphs.STATS)
    graphs.reset_counts()
    _reset_kernel_counts()
    img, jit_s = timed(jit, dev)
    launches, plain = _kernel_counts(), {**bk.PLAIN_CALLS, **bvk.PLAIN_CALLS}
    replayed = dict(graphs.STATS)
    launches = {k: v for k, v in launches.items() if v}
    eager_launches = {k: v for k, v in eager_launches.items() if v}
    if launches != eager_launches or not launches or any(plain.values()) \
            or replayed["captures"] != captures_per_call or not replayed["replays"]:
        raise AssertionError(f"{name}: replayed launches {launches} against eager "
                             f"{eager_launches}, plain calls {plain}, graphs {replayed}")
    shown = check(img, ref)
    busy = {"eager": eager_busy}
    for label, fn in zip(("eager", "jit"), profile or ()):
        if fn is None:
            continue
        fn()   # the jit render's capture, outside the profiled and timed calls
        profile_call(f"{name}_{label}", fn, dev)
        busy[label] = PROFILE_BUSY[f"{name}_{label}"]
    say(name, **fields, eager_render_s=None if eager_s is None else round(eager_s, 4),
        first_jit_s=round(first_s, 4), jit_render_s=round(jit_s, 4),
        first_call=first, replayed_call=replayed, launches=launches,
        eager_busy_share=busy["eager"], jit_busy_share=busy.get("jit"), **shown)
    return {name: launches}


def _equal(img, ref):
    diff = float((img - ref).abs().max())
    if diff != 0.0:
        raise AssertionError(f"replayed image {diff} off the eager one (bit for bit expected)")
    return {"max_abs_diff": diff}


def _atomics_close(img, ref):
    import torch

    diff = float((img - ref).abs().max())
    if not torch.allclose(img, ref, rtol=JIT_RTOL, atol=JIT_ATOL):
        raise AssertionError(f"replayed image {diff} off the eager one (C31: rtol "
                             f"{JIT_RTOL}, atol {JIT_ATOL})")
    return {"max_abs_diff": diff}


def _golden_close(img, ref):
    flips, diff = check_golden(img.cpu().numpy(), ref.cpu().numpy())
    return {"pixels_off": flips, "max_abs_diff": diff}


def phase_jit_cli_cornell(dev):
    """[jit_cli_cornell]: [cli_cornell]'s configuration (Cornell
    CLI_CORNELL_WIDTH^2, ldsampler at FRONTEND_SPP, Gaussian hdrfilm, the
    thin lens, depth 8: 8 chunks of 524,288 rays) through
    common.render_jit against common.render, at C31's bar;
    [jit_cli_cornell_box]: the same with the box film, bit for bit. Each
    profiled at JIT_PROFILE_SPP. Returns B1's launches by path."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common, path

    with tempfile.TemporaryDirectory() as tmp:
        _, _, scene, cam, cfg = cli_cornell_files(tmp, dev)
    cam = thin_lens(cam)
    out = {}
    for name, c, check in (("jit_cli_cornell", cfg, _atomics_close),
                           ("jit_cli_cornell_box",
                            dataclasses.replace(cfg, filter=film.FILTER_BOX), _equal)):
        small = dataclasses.replace(c, spp=JIT_PROFILE_SPP)
        out.update(jit_cell(
            name, lambda c=c: common.render(scene, cam, path.li, c),
            lambda c=c: common.render_jit(scene, cam, path.li, c), dev, check,
            profile=(lambda: common.render(scene, cam, path.li, small),
                     lambda: common.render_jit(scene, cam, path.li, small)),
            resolution=f"{cam.width}x{cam.height}", spp=c.spp, filter=c.filter,
            chunks=c.spp // c.resolve_chunk(cam.width, cam.height)))
    return out


def phase_jit_progressive(dev):
    """[jit_progressive]: render_progressive over [cli_cornell]'s scene and
    lens with the box film, JIT_PASSES passes of JIT_PASS_SPP (each pass
    one chunk of 1,048,576 rays): one capture, every later pass a replay;
    the image equal bit for bit to the same passes rendered eagerly by
    common.render and summed as render_progressive sums them. Returns B1's
    launches by path."""
    import dataclasses
    import tempfile

    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.utils import checkpoint, graphs

    with tempfile.TemporaryDirectory() as tmp:
        _, _, scene, cam, cfg = cli_cornell_files(tmp, dev)
    cam = thin_lens(cam)
    total = JIT_PASSES * JIT_PASS_SPP
    cfg = dataclasses.replace(cfg, spp=total, filter=film.FILTER_BOX)
    pass_cfg = dataclasses.replace(cfg, spp=JIT_PASS_SPP, spp_chunk=JIT_PASS_SPP)

    def eager():
        acc = np.zeros((cam.height, cam.width, 3), np.float32)
        for p in range(JIT_PASSES):
            img = common.render(scene, cam, path.li, pass_cfg, sample_offset=p * JIT_PASS_SPP)
            acc = acc + img.cpu().numpy() * JIT_PASS_SPP
        return acc / total

    _reset_kernel_counts()
    ref, eager_s = timed(eager, dev)
    eager_launches = _kernel_counts()
    common._CHUNK_GRAPHS.clear()
    graphs.reset_counts()
    _reset_kernel_counts()
    state, jit_s = timed(lambda: checkpoint.render_progressive(
        scene, cam, path.li, cfg, total_spp=total, pass_spp=JIT_PASS_SPP), dev)
    launches, stats = _kernel_counts(), dict(graphs.STATS)
    diff = float(np.abs(state.image - ref).max())
    say("jit_progressive", resolution=f"{cam.width}x{cam.height}", passes=JIT_PASSES,
        pass_spp=JIT_PASS_SPP, eager_render_s=round(eager_s, 4),
        progressive_render_s=round(jit_s, 4), graphs=stats,
        launches={k: v for k, v in launches.items() if v}, max_abs_diff=diff)
    if stats != {"captures": 1, "replays": JIT_PASSES - 1} or launches != eager_launches \
            or not launches["brute_closest"] or diff != 0.0:
        raise AssertionError(f"jit_progressive: graphs {stats}, launches {launches} against "
                             f"eager {eager_launches}, {diff} off the eager passes")
    return {"jit_progressive": {k: v for k, v in launches.items() if v}}


def phase_jit_mesh(dev):
    """[jit_mesh]: [cli_mesh]'s configuration (builtin.displaced_sphere's
    70,034 triangles, CLI_MESH_WIDTH^2 x 16 spp, path depth 4, rr 3, the
    box film) through common.render_jit, B2's closest and any-hit entries
    inside the graph, against common.render bit for bit. Returns B2's
    launches by path."""
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.displaced_sphere(width=CLI_MESH_WIDTH, height=CLI_MESH_WIDTH,
                                          device=dev)
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
    out = jit_cell("jit_mesh", lambda: common.render(scene, cam, path.li, cfg),
                   lambda: common.render_jit(scene, cam, path.li, cfg), dev, _equal,
                   profile=(lambda: common.render(scene, cam, path.li, cfg),
                            lambda: common.render_jit(scene, cam, path.li, cfg)),
                   tris=scene.num_triangles, resolution=f"{cam.width}x{cam.height}",
                   spp=cfg.spp)
    if not (out["jit_mesh"].get("bvh_closest") and out["jit_mesh"].get("bvh_any_hit")):
        raise AssertionError(f"jit_mesh: B2's entries not launched: {out}")
    return out


def phase_jit_wavefront(dev):
    """[jit_wavefront_headline]: the headline (Cornell 256x256, 256 spp,
    depth 8) through wavefront.render_jit, one step graph replayed per
    step, against [headline]'s eager image of this run at C8's bar, B1's
    launches equal to its. [jit_wavefront_bigmesh]: the big mesh, fuse +
    compact (a step graph per rung of the ladder, B2's fused entry inside
    each), against [bigmesh]'s. Busy shares of the headline at
    JIT_PROFILE_SPP. Returns the launches by path."""
    from mitsuba_tpu_torch.integrators import wavefront
    from mitsuba_tpu_torch.scene import builtin

    out = {}
    scene, cam, cfg = cornell_headline(dev, 256, 256)
    small = cornell_headline(dev, 256, JIT_PROFILE_SPP)[2]
    img, ref_cfg, launches = EAGER_IMAGES["headline"]
    if ref_cfg != cfg:
        raise AssertionError(f"jit_wavefront: [headline] rendered {ref_cfg}, not {cfg}")
    out.update(jit_cell(
        "jit_wavefront_headline", None, lambda: wavefront.render_jit(scene, cam, cfg), dev,
        _golden_close, eager_out=(img, launches),
        profile=(lambda: wavefront.render(scene, cam, small),
                 lambda: wavefront.render_jit(scene, cam, small)),
        resolution="256x256", spp=cfg.spp, steps=launches["brute_closest"]))
    scene, cam = builtin.displaced_sphere(device=dev)
    img, cfg, launches = EAGER_IMAGES["bigmesh"]
    kw = dict(lanes_per_pixel=4, compact=True, fuse=True)
    out.update(jit_cell(
        "jit_wavefront_bigmesh", None, lambda: wavefront.render_jit(scene, cam, cfg, **kw),
        dev, _golden_close, eager_out=(img, launches), tris=scene.num_triangles,
        resolution=f"{cam.width}x{cam.height}", spp=cfg.spp,
        steps=launches["bvh_closest_and_any"], ladder=wavefront._ladder(cam.width * cam.height
                                                                        * 4)))
    return out


JIT_PHASES = (phase_jit_cli_cornell, phase_jit_progressive, phase_jit_mesh,
              phase_jit_wavefront)


# The film renderers' compiled renders (the [jit_film] group): each
# render_jit against the eager render of the same configuration in this
# run, the earlier groups' cell of that configuration (EAGER_CELLS: its
# image, launches and seconds; its [profile] line's busy share at
# BIDIR_PROFILE_SPP, at which the jit render is profiled too). Bit for bit
# where no atomics sum the image (bre, the sharded box film, the
# irradiance cache's film); C31's bar where `index_add_` splats (ptracer,
# the light image). The Metropolis cells ([pssmlt], [erpt], [mlt],
# [mlt_caustic]) render under torch's deterministic algorithms
# (`deterministic`), and their render_jit under them too, bit for bit.
def film_jit_cell(name, eager_name, make, cfg, dev, check, **fields):
    """[name]: make(cfg), a render through render_jit, in a jit_cell against
    EAGER_CELLS[eager_name] (rendered with the same cfg, or raise). Both
    busy shares at the eager cell's profile size (BIDIR_PROFILE_SPP: spp,
    or mutations): the eager cell's [profile] line and the jit render's,
    replayed. Returns {name: launches}."""
    import dataclasses

    img, eager_cfg, launches, eager_s = EAGER_CELLS[eager_name]
    if eager_cfg != cfg:
        raise AssertionError(f"{name}: [{eager_name}] rendered {eager_cfg}, not {cfg}")
    small = dataclasses.replace(cfg, spp=min(cfg.spp, BIDIR_PROFILE_SPP))
    return jit_cell(name, None, lambda: make(cfg), dev, check, eager_out=(img, launches),
                    eager_s=eager_s, eager_busy=PROFILE_BUSY[eager_name],
                    profile=(None, lambda: make(small)), busy_spp=small.spp, **fields)


def phase_jit_bidir(dev):
    """[jit_ptracer]: ptracer.render_jit on the headline's Cornell box at
    256x256 x 16 spp, depth 8 (1,048,576 particles: one chunk graph, two
    chunks), against [ptracer]; [jit_bdpt_light_image]: bdpt.render_jit
    (one spp-chunk graph: the eye strategies and the light image's
    splats) against [bdpt_light_image]. C31's bar (the splats' atomics).
    Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import bdpt, ptracer
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(BIDIR_WIDTH, BIDIR_WIDTH, device=dev)
    cfg = _bidir_cfg()
    out = {}
    out.update(film_jit_cell("jit_ptracer", "ptracer", lambda c: ptracer.render_jit(scene, cam, c),
                             cfg, dev, _atomics_close, resolution=f"{cam.width}x{cam.height}",
                             spp=cfg.spp, particles=cam.width * cam.height * cfg.spp))
    out.update(film_jit_cell("jit_bdpt_light_image", "bdpt_light_image",
                             lambda c: bdpt.render_jit(scene, cam, c), cfg, dev, _atomics_close,
                             resolution=f"{cam.width}x{cam.height}", spp=cfg.spp))
    return out


def phase_jit_bre(dev):
    """[jit_bre]: bre.render_jit on tests/test_bre.py's fog (2^16 paths,
    BRE_STEPS steps, 256x256): the prologue graph (photons, the grid's
    sort, camera rays) and one step graph replayed per step, against
    [bre] bit for bit. Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import bre
    from mitsuba_tpu_torch.models import medium
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(PHOTON_WIDTH, PHOTON_WIDTH, device=dev)
    scene = scene.replace(medium=medium.make_homogeneous(*BRE_FOG, g=0.0, device=dev))
    return film_jit_cell(
        "jit_bre", "bre",
        lambda c: bre.render_jit(scene, cam, c, n_paths=BRE_PATHS, steps=BRE_STEPS),
        _bidir_cfg(1), dev, _equal, resolution=f"{cam.width}x{cam.height}", paths=BRE_PATHS,
        steps=BRE_STEPS)


def chains_jit_cell(name, eager_name, make, cfg, dev, **fields):
    """[name]: a Metropolis render_jit in a film_jit_cell against the eager
    cell `eager_name`, both under deterministic(), bit for bit: the
    generator registered with each graph draws what the eager chains draw.
    Returns {name: launches}."""
    with deterministic():
        return film_jit_cell(name, eager_name, make, cfg, dev, _equal,
                             algorithms="deterministic", **fields)


def phase_jit_mcmc(dev):
    """[jit_pssmlt], [jit_erpt]: pssmlt.render_jit and erpt.render_jit at
    [pssmlt]'s and [erpt]'s configuration (256x256, depth 8, 2^15 chains x
    MCMC_MUTATIONS mutations, 2^17 bootstrap paths, seed 0): the
    bootstrap eager, one mutation graph (the generator registered)
    replayed per mutation, against the eager cell bit for bit
    (chains_jit_cell). Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import erpt, pssmlt
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(DAYLIGHT_WIDTH, DAYLIGHT_WIDTH, device=dev)
    kw = dict(n_chains=MCMC_CHAINS, n_bootstrap=MCMC_BOOTSTRAP)
    out = {}
    for name, mod, count in (("pssmlt", pssmlt, "n_mutations"), ("erpt", erpt, "chain_length")):
        out.update(chains_jit_cell(
            f"jit_{name}", name,
            lambda c, mod=mod, count=count: mod.render_jit(scene, cam, c, **{count: c.spp}, **kw),
            _bidir_cfg(MCMC_MUTATIONS), dev, resolution=f"{cam.width}x{cam.height}",
            chains=MCMC_CHAINS, mutations=MCMC_MUTATIONS, bootstrap=MCMC_BOOTSTRAP))
    return out


def phase_jit_mlt(dev):
    """[jit_mlt]: mlt.render_jit at [mlt]'s configuration (the Cornell box
    at MLT_WIDTH^2, depth 8, 2^14 chains x MLT_MUTATIONS mutations: five
    kernel graphs replayed in the eager order); [jit_mlt_caustic]:
    [mlt_caustic]'s (caustic_box with a perfect mirror, depth 4,
    MLT_CAUSTIC_MUTATIONS mutations: six kernel graphs, F's two manifold
    walks a step inside its graph, 20 Newton iterations each, where
    [mlt_caustic]'s eager walks exit when the global condition falls).
    Each against its eager cell bit for bit (chains_jit_cell), its
    launches equal to the eager cell's. Returns B1's launches by path."""
    from mitsuba_tpu_torch.integrators import mlt
    from mitsuba_tpu_torch.scene import builtin

    kw = dict(n_chains=MLT_CHAINS, n_bootstrap=MLT_BOOTSTRAP)
    scene, cam = builtin.cornell_box(MLT_WIDTH, MLT_WIDTH, device=dev)
    out = chains_jit_cell(
        "jit_mlt", "mlt", lambda c: mlt.render_jit(scene, cam, c, n_mutations=c.spp, **kw),
        _bidir_cfg(MLT_MUTATIONS, BIDIR_DEPTH), dev, resolution=f"{cam.width}x{cam.height}",
        chains=MLT_CHAINS, mutations=MLT_MUTATIONS, kernels=5)
    scene, cam = builtin.caustic_box(MLT_WIDTH, MLT_WIDTH, rough=False, device=dev)
    out.update(chains_jit_cell(
        "jit_mlt_caustic", "mlt_caustic",
        lambda c: mlt.render_jit(scene, cam, c, n_mutations=c.spp, **kw),
        _bidir_cfg(MLT_CAUSTIC_MUTATIONS, MLT_CAUSTIC_DEPTH), dev,
        resolution=f"{cam.width}x{cam.height}", chains=MLT_CHAINS,
        mutations=MLT_CAUSTIC_MUTATIONS, kernels=6, walk="fixed"))
    return out


def phase_jit_irrcache(dev):
    """[jit_irrcache]: irrcache.render (the cache eager, the film through
    common.render_jit: its Li is new each call, so each call captures one
    chunk graph and replays it) at [irrcache]'s configuration, against
    [irrcache]'s eager render bit for bit. Returns B1's launches by
    path."""
    from mitsuba_tpu_torch.integrators import irrcache
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(PHOTON_WIDTH, PHOTON_WIDTH, device=dev)
    cfg = _bidir_cfg(IRR_SPP, IRR_DEPTH)
    img, eager_cfg, launches, eager_s = EAGER_CELLS["irrcache"]
    if eager_cfg != cfg:
        raise AssertionError(f"jit_irrcache: [irrcache] rendered {eager_cfg}")
    return jit_cell("jit_irrcache", None,
                    lambda: irrcache.render(scene, cam, cfg, n_points=IRR_POINTS,
                                            n_hemi=IRR_HEMI),
                    dev, _equal, eager_out=(img, launches), eager_s=eager_s,
                    eager_busy=PROFILE_BUSY["irrcache"], captures_per_call=1,
                    resolution=f"{cam.width}x{cam.height}", spp=cfg.spp, points=IRR_POINTS,
                    hemisphere_rays=IRR_HEMI)


def phase_jit_sharded(dev):
    """[jit_sharded]: render_sharded_jit on a one-rank NCCL group (mesh (1,
    1)) at [sharded]'s configuration (the Cornell box at 256x256 x 16 spp,
    depth 8, the box film: the rank's chunk graph over its pixel ids, the
    collectives outside it); [jit_sharded_mesh]: the 70,034-triangle
    sphere at [sharded_mesh]'s (B2 inside the graph). Each against its
    eager cell bit for bit. Returns the launches by path."""
    from mitsuba_tpu_torch.film import film
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.parallel import render_sharded as rs
    from mitsuba_tpu_torch.scene import builtin

    out = {}
    with world_one_group() as backend:
        mesh = rs.make_mesh(1, sp=1)
        scene, cam = builtin.cornell_box(PARALLEL_WIDTH, PARALLEL_WIDTH, device=dev)
        cfg = common.RenderConfig(spp=SHARDED_SPP, max_depth=SHARDED_DEPTH, rr_depth=5, seed=0,
                                  filter=film.FILTER_BOX)
        out.update(film_jit_cell(
            "jit_sharded", "sharded",
            lambda c: rs.render_sharded_jit(scene, cam, path.li, c, mesh), cfg, dev, _equal,
            backend=backend, mesh="(1, 1)", resolution=f"{cam.width}x{cam.height}",
            spp=cfg.spp))
        mscene, mcam = builtin.displaced_sphere(width=CLI_MESH_WIDTH, height=CLI_MESH_WIDTH,
                                                device=dev)
        cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=0)
        out.update(film_jit_cell(
            "jit_sharded_mesh", "sharded_mesh",
            lambda c: rs.render_sharded_jit(mscene, mcam, path.li, c, mesh), cfg, dev, _equal,
            backend=backend, mesh="(1, 1)", tris=mscene.num_triangles,
            resolution=f"{mcam.width}x{mcam.height}", spp=cfg.spp))
    if not (out["jit_sharded_mesh"].get("bvh_closest") and
            out["jit_sharded_mesh"].get("bvh_any_hit")):
        raise AssertionError(f"jit_sharded_mesh: B2's entries not launched: {out}")
    return out


JIT_FILM_PHASES = (phase_jit_bidir, phase_jit_bre, phase_jit_mcmc, phase_jit_mlt,
                   phase_jit_irrcache, phase_jit_sharded)

def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and run the kernel phases only (no renders); "
                         "prints no result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import mitsuba_tpu_torch  # noqa: F401  (fails here when run without the repo)
    from mitsuba_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = _build.build_all(["brute_intersect", "bvh_intersect", "gather_backward", "rng_draw"])
    say("build", libraries=[lib.name for lib in libs],
        seconds=round(time.perf_counter() - t0, 3))
    for lib in libs:
        say("ptxas", library=lib.name.split("-")[0], info=_build.build_log(lib))

    report = phase_kernels(dev, KERNEL_RAYS, 256 * 256)
    report.update(phase_bvh_kernel(dev))
    phase_kernel_edges(dev)
    phase_crossover(dev)
    report.update(phase_gather_kernel(dev))
    report.update(phase_draw_kernel(dev))
    if args.kernels_only:
        print(json.dumps({"kernels_only": report}), flush=True)
        return 0
    phase_golden(dev)
    brute = phase_headline(dev, 256, 256)
    phase_profile("headline", *cornell_headline(dev, 256, 4))
    phase_mesh(dev, 64, 16)
    # each path's launches, counted from 0 just before it and read just
    # after; a kernel's "launches" are those of the path it serves
    paths = {"headline_render": {f"brute_{k}": v for k, v in brute.items()}}
    for path, counts in phase_bigmesh(dev).items():
        paths[path] = {f"bvh_{k}": v for k, v in counts.items()}
    phase_grad_kernels(dev)
    phase_grad_shadow(dev)
    paths["grad_mesh"] = {f"bvh_{k}": v for k, v in phase_grad_mesh(dev).items()}
    paths["grad_headline"] = {f"brute_{k}": v
                              for k, v in phase_grad_headline(dev, GRAD_HEADLINE_SPP).items()}
    t_materials = time.perf_counter()
    phase_golden_materials(dev)
    for path, phase in (("veach_render", phase_veach), ("envmap_render", phase_envmap_textured),
                        ("grad_materials", phase_grad_materials)):
        paths[path] = {f"brute_{k}": v for k, v in phase(dev).items()}
    t_media = time.perf_counter()
    media_s = {}
    for phase in (phase_golden_volpath, phase_volpath, phase_volpath_grid,
                  phase_volpath_delta, phase_volpath_mesh, phase_grad_medium):
        t0 = time.perf_counter()
        paths.update(phase(dev))
        media_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_frontend = time.perf_counter()
    frontend_s = {}
    for phase in (phase_frontend, phase_samplers, phase_filters, phase_sensors, phase_tiled,
                  phase_vertex_colors):
        t0 = time.perf_counter()
        paths.update(phase(dev))
        frontend_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_cli = time.perf_counter()
    cli_s = {}
    for phase in (phase_cli_cornell, phase_cli_mesh):
        t0 = time.perf_counter()
        paths.update(phase(dev))
        cli_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_bidir = time.perf_counter()
    bidir_s = {}
    for phase in BIDIR_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        bidir_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_photon = time.perf_counter()
    photon_s = {}
    for phase in PHOTON_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        photon_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_daylight = time.perf_counter()
    daylight_s = {}
    for phase in DAYLIGHT_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        daylight_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_mlt = time.perf_counter()
    mlt_s = {}
    for phase in MLT_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        mlt_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_parallel = time.perf_counter()
    parallel_s = {}
    for phase in PARALLEL_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        parallel_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_jit = time.perf_counter()
    jit_s = {}
    for phase in JIT_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        jit_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_film = time.perf_counter()
    jit_film_s = {}
    for phase in JIT_FILM_PHASES:
        t0 = time.perf_counter()
        paths.update(phase(dev))
        jit_film_s[phase.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 3)
    t_end = time.perf_counter()
    say("total", seconds=round(t_end - t_start, 3),
        materials_seconds=round(t_media - t_materials, 3),
        media_seconds=round(t_frontend - t_media, 3), media_phase_seconds=media_s,
        frontend_seconds=round(t_cli - t_frontend, 3), frontend_phase_seconds=frontend_s,
        cli_seconds=round(t_bidir - t_cli, 3), cli_phase_seconds=cli_s,
        bidir_seconds=round(t_photon - t_bidir, 3), bidir_phase_seconds=bidir_s,
        photon_seconds=round(t_daylight - t_photon, 3), photon_phase_seconds=photon_s,
        daylight_seconds=round(t_mlt - t_daylight, 3), daylight_phase_seconds=daylight_s,
        mlt_seconds=round(t_parallel - t_mlt, 3), mlt_phase_seconds=mlt_s,
        parallel_seconds=round(t_jit - t_parallel, 3), parallel_phase_seconds=parallel_s,
        jit_seconds=round(t_film - t_jit, 3), jit_phase_seconds=jit_s,
        jit_film_seconds=round(t_end - t_film, 3), jit_film_phase_seconds=jit_film_s)
    kernels = []
    for name, (source, replaces, path, _) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": paths[path][name],
                        **report[name], "path": path,
                        "launches_by_path": {p: c[name] for p, c in paths.items()
                                             if name in c}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
