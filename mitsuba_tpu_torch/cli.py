"""Command-line renderer: `python -m mitsuba_tpu_torch scene.xml [-o out.exr]`
(port of cli.py).

The analog of the `mitsuba` CLI frontend (src/mitsuba/mitsuba.cpp:129
mitsuba_app): parse the scene, pick the integrator, render on the CUDA
device (or the CPU with --cpu), develop the film to disk. Flags mirror the
JAX package's CLI:
  -D key=value   parameter substitution ($key in XML, mitsuba.cpp:58,168)
  -o file        output (EXR/PNG/PFM/NPY/HDR by extension)
  -s spp         override sample count
  -d depth       override maxDepth
  -t seed        RNG seed
  -a path        prepend a file-resolver search path
  -q / -v        quiet / debug log level; --log-file appends records
  --mesh DP,SP   render sharded over DP x SP ranks, one device each:
                 pixels over "dp", samples over "sp" (parallel/)
  --distributed HOST:PORT,N,I
                 this process is rank I of N in a torch.distributed group
                 at tcp://HOST:PORT; only rank 0 writes the image
A scene above trace.BRUTE_MAX_TRIS triangles gets its BVH here, so it
takes the BVH kernel; a smaller one the brute-force kernel. An integrator
with a per-ray Li renders through common.render_jit (CUDA graphs on the
card), its progressive passes (-r) and time bins too, as the JAX CLI
renders through its render_jit; the film renderers keep their own.

`--mesh` without `--distributed` starts its ranks itself: the command
runs as rank 0 and spawns DP*SP - 1 copies of itself with `--distributed
127.0.0.1:<free port>,DP*SP,I`, waits for them and fails if one fails.
The ranks meet in the store at HOST:PORT and each learns from it which
ranks share its host (parallel.render_sharded.node_layout): a rank
renders on cuda:(its index among them % cards), or the CPU under --cpu;
the backend is NCCL where every rank of a host has a card of its own,
gloo where ranks share a card or run on the CPU, fixed before the group
starts and printed by every rank. Ranks on several hosts need nothing
more than the same HOST:PORT.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import time

# the integrators whose Li function the port has, as (module, function)
_LI_NAMES = {"path": ("path", "li"), "mypath": ("path", "li"), "mypath2": ("path", "li"),
             "direct": ("direct", "li"), "volpath": ("volpath", "li"),
             "volpath_simple": ("volpath", "li"), "depth": ("aov", "li_depth"),
             "normal": ("aov", "li_normal"), "field": ("aov", "li_normal"),
             "ao": ("aov", "li_ao"), "motion": ("aov", "li_motion"), "bdpt": ("bdpt", "li"),
             "mybdpt": ("bdpt", "li"), "mybdpt2": ("bdpt", "li"), "lvcbpt": ("lvcbpt", "li"),
             "vpl": ("vpl", "li"), "spectral": ("spectral", "li"),
             "spectral_path": ("spectral", "li")}
# the integrators that render the whole film themselves: resolve_integrator
# returns the name
_FILM_RENDERERS = ("ptracer", "multichannel", "sppm", "ppm", "photonmapper", "bre",
                   "irrcache", "pssmlt", "erpt", "mlt")


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="PyTorch + CUDA Monte Carlo renderer (Mitsuba-compatible scenes)",
    )
    ap.add_argument("scene", nargs="+", help="scene XML file(s)")
    ap.add_argument("-o", "--output", default=None, help="output image file")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="define a scene parameter ($key substitution)")
    ap.add_argument("-s", "--spp", type=int, default=None, help="override spp")
    ap.add_argument("-d", "--depth", type=int, default=None, help="override maxDepth")
    ap.add_argument("-t", "--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("-a", action="append", default=[], metavar="path",
                    dest="search_paths",
                    help="prepend a file-resolver search path "
                         "(repeatable; mitsuba -a parity)")
    ap.add_argument("--integrator", default=None,
                    help="override integrator (path, direct, volpath, bdpt, lvcbpt, "
                         "vpl, ptracer, multichannel, sppm, ppm, photonmapper, bre, "
                         "irrcache, pssmlt, erpt, mlt, spectral, depth, normal, ao, "
                         "motion, ...)")
    ap.add_argument("--mesh", default=None, metavar="DP,SP",
                    help="sharded rendering over DP x SP ranks, one device each "
                         "(pixels over DP, samples over SP); without "
                         "--distributed the command spawns the other ranks")
    ap.add_argument("--distributed", default=None, metavar="HOST:PORT,N,I",
                    help="join a torch.distributed group of N processes at "
                         "tcp://HOST:PORT as rank I (every process runs the "
                         "same command with its own I); only rank 0 writes")
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="render multiple scenes concurrently (mitsuba.cpp -j): "
                         "a thread pool overlaps one scene's loading with "
                         "another's rendering")
    ap.add_argument("--time-bins", type=int, default=1, metavar="K",
                    help="object motion blur: render K stratified shutter"
                         " times (animated toWorldEnd / deformable shapes)"
                         " and average")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="EDebug log level (mitsuba.cpp -v)")
    ap.add_argument("--log-file", default=None, metavar="PATH",
                    help="also append log records to a file "
                         "(StreamAppender/logger.h analog)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the default is the CUDA device)")
    ap.add_argument("-r", "--refresh", type=float, default=None, metavar="SEC",
                    help="render in progressive passes and write the partial "
                         "image every SEC seconds (0: after every pass; "
                         "mitsuba.cpp:107-127 -r flush thread; SIGHUP also "
                         "forces a flush)")
    ap.add_argument("--debug-fp", action="store_true",
                    help="check the image, each progressive pass and each "
                         "tiled-film band with "
                         "torch.isfinite and exit non-zero naming the first "
                         "NaN/Inf pixel (a check of the result, not JAX's "
                         "per-op trap)")
    return ap


def resolve_integrator(name: str):
    """The port's Li function for an integrator name, or the name itself for
    the integrators that render the whole film themselves (ptracer,
    multichannel, the photon mappers, bre, irrcache, pssmlt, erpt, mlt);
    exits listing the names it knows for any other."""
    if name in _FILM_RENDERERS:
        return name
    if name not in _LI_NAMES:
        raise SystemExit(f"unknown integrator '{name}'; have: "
                         f"{sorted(_LI_NAMES) + list(_FILM_RENDERERS)}")
    import importlib

    module, fn = _LI_NAMES[name]
    return getattr(importlib.import_module(f".integrators.{module}", __package__), fn)


def _device(args):
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to render on the CPU")
    return torch.device("cuda", 0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = build_argparser().parse_args(argv)
    args.argv = argv
    if (args.mesh or args.distributed) and len(args.scene) > 1:
        raise SystemExit("--mesh and --distributed render one scene")
    from .core import logger as loglib

    logger = loglib.get_logger()
    level = logger.level
    if args.quiet:
        logger.set_log_level(loglib.EWarn)
    elif args.verbose:
        logger.set_log_level(loglib.EDebug)
    appender = loglib.FileAppender(args.log_file) if args.log_file else None
    if appender is not None:
        logger.add_appender(appender)
    try:
        if len(args.scene) > 1:
            # multi-scene batch (mitsuba.cpp -j): a thread pool overlaps the
            # host-side scene loading and dispatch
            import concurrent.futures as cf

            def one(scene_path):
                a = copy.copy(args)
                a.scene = [scene_path]
                if args.output:
                    a.output = multi_output(args.output, scene_path)
                return _render_one(a)

            with cf.ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as ex:
                list(ex.map(one, args.scene))
            return 0
        return _render_one(args)
    finally:
        logger.set_log_level(level)
        if appender is not None:
            logger.appenders.remove(appender)
            appender.close()


def multi_output(output: str, scene_path: str) -> str:
    """-o out.exr with several scenes: out_<scene stem>.exr per scene."""
    base, ext = output.rsplit(".", 1)
    stem = scene_path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    return f"{base}_{stem}.{ext}"


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_finite(img, what: str, y0: int = 0) -> None:
    """--debug-fp: exit naming the first pixel (row-major) with a NaN/Inf;
    `img` holds the film's rows from y0 on."""
    import torch

    img = torch.as_tensor(img)
    bad = ~torch.isfinite(img).reshape(img.shape[0], img.shape[1], -1).all(-1)
    if bad.any():
        y, x = torch.nonzero(bad)[0].tolist()
        raise SystemExit(f"--debug-fp: {what} has a non-finite value at pixel "
                         f"(row {y0 + y}, column {x})")


def _load(scene_path, defaults, args, dev, time_=0.0):
    """load_xml, then the automatic BVH above trace.BRUTE_MAX_TRIS.
    Returns (scene, cam, cfg, integrator name, load seconds, BVH seconds)."""
    from .ops import trace
    from .scene import bvh as bvhlib, xml as xmllib

    t0 = time.perf_counter()
    scene, cam, cfg, integ_name = xmllib.load_xml(
        scene_path, defaults=defaults, time=time_, search_paths=args.search_paths,
        device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    bvh_s = 0.0
    # large scenes get a BVH automatically (kd-tree build analog,
    # scene.cpp:340 Scene::initialize), at the JAX CLI's threshold
    if scene.num_triangles > trace.BRUTE_MAX_TRIS and scene.bvh is None:
        t0 = time.perf_counter()
        scene = bvhlib.attach(scene)
        _sync(dev)
        bvh_s = time.perf_counter() - t0
    return scene, cam, cfg, integ_name, load_s, bvh_s


def _parse_mesh(value: str):
    try:
        dp, sp = (int(x) for x in value.split(","))
    except ValueError:
        raise SystemExit(f"bad --mesh '{value}', expected DP,SP") from None
    if dp < 1 or sp < 1:
        raise SystemExit(f"bad --mesh '{value}', expected DP,SP")
    return dp, sp


def _parse_distributed(value: str):
    try:
        coord, n, i = value.split(",")
        n, i = int(n), int(i)
    except ValueError:
        raise SystemExit(f"bad --distributed '{value}', expected "
                         "HOST:PORT,NUM_PROCS,PROCESS_ID") from None
    return coord, n, i


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(args, n: int):
    """--mesh without --distributed: this process becomes rank 0 of a group
    of n at a free local port, and n - 1 copies of the command join it as
    ranks 1..n-1. Returns the workers (subprocess.Popen)."""
    import subprocess

    coord = f"127.0.0.1:{_free_port()}"
    args.distributed = f"{coord},{n},0"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([root, *filter(None, [os.environ.get("PYTHONPATH")])])}
    return [subprocess.Popen([sys.executable, "-m", __package__, *args.argv,
                              "--distributed", f"{coord},{n},{i}"], env=env)
            for i in range(1, n)]


def _join_ranks(workers, failed: bool):
    """Wait for the spawned ranks (killed where this rank failed); exits
    naming any that failed."""
    bad = []
    for i, p in enumerate(workers, start=1):
        if failed:
            p.kill()
        if p.wait() != 0 and not failed:
            bad.append(f"rank {i} exited {p.returncode}")
    if bad:
        raise SystemExit("--mesh: " + ", ".join(bad))


def _render_one(args):
    if not args.mesh and not args.distributed:
        return _render_rank(args, _device(args))
    import torch

    workers = []
    if args.mesh:
        dp, sp = _parse_mesh(args.mesh)
        if not args.cpu and not args.distributed and dp * sp > torch.cuda.device_count():
            raise SystemExit(f"--mesh {args.mesh} needs {dp * sp} devices but only "
                             f"{torch.cuda.device_count()} are available")
        if not args.distributed:
            workers = _spawn_ranks(args, dp * sp)
    failed = True
    try:
        code = _render_distributed(args)
        failed = code != 0
        return code
    finally:
        _join_ranks(workers, failed)


def _render_distributed(args):
    """This process as one rank of a torch.distributed group: start the
    group (backend fixed before, printed), render (sharded under --mesh),
    and leave it."""
    import torch.distributed as dist

    from .parallel import render_sharded as rs

    coord, n, rank = _parse_distributed(args.distributed)
    dp, sp = _parse_mesh(args.mesh) if args.mesh else (n, 1)
    if dp * sp > n:
        raise SystemExit(f"--mesh {args.mesh} needs {dp * sp} devices but only "
                         f"{n} are available")
    if dp * sp < n:
        raise SystemExit(f"--mesh {args.mesh} covers {dp * sp} of the group's {n} ranks")
    _device(args)    # exits where there is no card and --cpu is not given
    dev, backend = rs.start_group(f"tcp://{coord}", n, rank, cpu=args.cpu)
    print(f"[mitsuba_tpu_torch] rank {rank} of {n}: backend {backend}, device {dev}",
          file=sys.stderr, flush=True)
    try:
        mesh = rs.make_mesh(n, sp=sp, device=dev) if args.mesh else None
        return _render_rank(args, dev, rank=rank, mesh=mesh)
    finally:
        dist.destroy_process_group()


def _render_rank(args, dev, rank: int = 0, mesh=None):
    """Load and render the scene on `dev`; rank 0 writes the image. Under a
    mesh, an integrator with a per-ray Li renders sharded over it."""
    t0 = time.time()

    defaults = {}
    for d in args.D:
        if "=" not in d:
            raise SystemExit(f"bad -D argument '{d}', expected key=value")
        k, v = d.split("=", 1)
        defaults[k] = v

    scene_path = args.scene[0] if isinstance(args.scene, list) else args.scene
    if not os.path.exists(scene_path):
        raise SystemExit(f"scene file not found: {scene_path}")
    scene, cam, cfg, integ_name, load_s, bvh_s = _load(scene_path, defaults, args, dev)
    if args.spp:
        cfg = dataclasses.replace(cfg, spp=args.spp)
    if args.depth:
        cfg = dataclasses.replace(cfg, max_depth=args.depth)
    if args.seed:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    li_fn = resolve_integrator(args.integrator or integ_name)

    from .core import logger as loglib
    from .integrators import common
    from .io import image as imagelib
    from .utils import stats as statslib

    loglib.Log(loglib.EInfo,
               "%d triangles, %dx%d @ %d spp, integrator=%s",
               scene.num_triangles, cam.width, cam.height, cfg.spp,
               args.integrator or integ_name)
    st = statslib.get_statistics()
    st.add("Scene.triangles", scene.num_triangles)
    st.add("Scene.pixels", cam.width * cam.height)
    out = args.output or (scene_path.rsplit(".", 1)[0] + ".exr")

    t_render, bin_loads = time.perf_counter(), 0.0
    if rank != 0 and (li_fn == "multichannel" or (cfg.film_tiled and mesh is None)):
        # the film streams to disk (or one file per channel): rank 0's alone
        loglib.Log(loglib.EInfo, "rank %d: rank 0 writes the film", rank)
        return 0
    if li_fn == "multichannel":
        # one image per channel: out.exr (radiance), out_depth.exr, ...
        from .integrators import multichannel

        base, ext = out.rsplit(".", 1)
        outs = multichannel.render(scene, cam, cfg)
        for ch, arr in outs.items():
            p = out if ch == "radiance" else f"{base}_{ch}.{ext}"
            imagelib.write_image(p, arr.cpu().numpy())
            loglib.Log(loglib.EInfo, "wrote %s", p)
        _record_times(st, load_s, bvh_s, time.perf_counter() - t_render)
        st.add("Render.wall_clock", time.time() - t0, unit="s")
        if not args.quiet:
            st.print_stats()
        return 0
    if li_fn in _FILM_RENDERERS:
        img = render_film(li_fn, scene, cam, cfg).cpu().numpy()
    elif mesh is not None:
        from .parallel import render_sharded as rs

        img = rs.render_sharded(scene, cam, li_fn, cfg, mesh).cpu().numpy()
    elif args.time_bins > 1:
        # time-binned object motion blur (deformable.cpp / track.h
        # analog): each bin re-loads the scene at a stratified shutter time
        img = None
        for b in range(args.time_bins):
            scene_b, cam_b, _, _, lb, bb = _load(scene_path, defaults, args, dev,
                                                 time_=(b + 0.5) / args.time_bins)
            load_s, bvh_s, bin_loads = load_s + lb, bvh_s + bb, bin_loads + lb + bb
            cfg_b = dataclasses.replace(cfg, seed=cfg.seed + b * 7919)
            img_b = common.render_jit(scene_b, cam_b, li_fn, cfg_b).cpu().numpy()
            img = img_b if img is None else img + img_b
        img = img / args.time_bins
    elif cfg.film_tiled:
        # tiledhdrfilm: row bands streamed straight to the EXR
        from .film import tiled as tiledlib

        if not out.endswith(".exr"):
            raise SystemExit("tiledhdrfilm requires an .exr output")
        mean = tiledlib.render_tiled(
            scene, cam, li_fn, cfg, out,
            metadata={"spp": float(cfg.spp), "generatedBy": "mitsuba_tpu_torch"},
            progress=not args.quiet,
            check=(lambda band, y0: _check_finite(band, "the image", y0)) if args.debug_fp
            else None)
        _record_times(st, load_s, bvh_s, time.perf_counter() - t_render)
        render_s = time.time() - t0
        st.add("Render.wall_clock", render_s, unit="s")
        loglib.Log(loglib.EInfo, "wrote %s in %.1fs (mean %.4f, tiled)",
                   out, render_s, mean)
        if not args.quiet:
            st.print_stats()
        return 0
    elif args.refresh is not None:
        img = _render_progressive(args, scene, cam, li_fn, cfg, out)
    else:
        img = common.render_jit(scene, cam, li_fn, cfg).cpu().numpy()
    _record_times(st, load_s, bvh_s, time.perf_counter() - t_render - bin_loads)
    if args.debug_fp:
        _check_finite(img, "the image")
    if rank != 0:
        # only rank 0 develops the film (mtssrv workers never write; the
        # client assembles, mitsuba.cpp:311)
        loglib.Log(loglib.EInfo, "worker %d done (mean %.4f)", rank, img.mean())
        return 0

    render_s = time.time() - t0
    # renderTime in the EXR header (film metadata the reference stamps;
    # read back by data/scripts/rendertime.py:14)
    meta = {"renderTime": render_s,
            "spp": float(cfg.spp),
            "generatedBy": "mitsuba_tpu_torch"} if out.endswith(".exr") else None
    imagelib.write_image(out, img, metadata=meta)
    st.add("Render.wall_clock", render_s, unit="s")
    st.add("Render.samples", float(cfg.spp) * cam.width * cam.height)
    loglib.Log(loglib.EInfo, "wrote %s in %.1fs (mean %.4f)",
               out, render_s, img.mean())
    if not args.quiet:
        # Statistics::printStats at exit (mitsuba.cpp:408)
        st.print_stats()
    return 0


def render_film(name, scene, cam, cfg):
    """The image of an integrator that renders the whole film itself, with
    the JAX CLI's pass, photon and mutation counts from cfg.spp. Path-space
    mlt renders area-lit scenes; a scene with an environment or delta
    lights takes pssmlt, as the JAX CLI routes it (mlt's paths end on area
    emitters)."""
    if name == "ptracer":
        from .integrators import ptracer

        return ptracer.render(scene, cam, cfg)
    if name == "photonmapper":
        from .integrators import photonmapper

        return photonmapper.render(scene, cam, cfg, n_passes=max(min(cfg.spp // 4, 16), 1))
    if name in ("sppm", "ppm"):
        from .integrators import sppm

        return sppm.render(scene, cam, cfg, n_passes=max(cfg.spp // 4, 1))[0]
    if name == "bre":
        from .integrators import bre

        return bre.render(scene, cam, cfg)
    if name == "mlt":
        if scene.has_area and not (scene.has_env or scene.delta_emitters is not None):
            from .integrators import mlt

            return mlt.render(scene, cam, cfg, n_mutations=max(cfg.spp, 64))
        from .core import logger as loglib

        loglib.Log(loglib.EInfo, "mlt: the scene has an environment or delta lights, "
                   "rendering with pssmlt")
        name = "pssmlt"
    if name == "pssmlt":
        from .integrators import pssmlt

        return pssmlt.render(scene, cam, cfg, n_mutations=max(cfg.spp, 64))
    if name == "erpt":
        from .integrators import erpt

        return erpt.render(scene, cam, cfg, chain_length=max(cfg.spp, 64))
    from .integrators import irrcache

    return irrcache.render(scene, cam, cfg)


def _record_times(st, load_s, bvh_s, render_s):
    """The run's phases as gauges: Time.load (parse, mesh reads, scene
    build), Time.bvh (the automatic BVH), Time.render (the render and its
    copy to the host; the tiled film's band writes included), each ending
    in a device synchronise."""
    st.record("Time.load", load_s, unit="s")
    st.record("Time.bvh", bvh_s, unit="s")
    st.record("Time.render", render_s, unit="s")


def _render_progressive(args, scene, cam, li_fn, cfg, out):
    """Progressive passes with a periodic / SIGHUP partial-image flush
    (mitsuba.cpp:91-127: SIGHUP handler + `-r sec` flush thread)."""
    import signal

    from .core import logger as loglib
    from .io import image as imagelib
    from .utils import checkpoint as ckpt

    flush_req = {"at": time.time(), "force": False}

    def _on_hup(signum, frame):
        flush_req["force"] = True

    try:
        signal.signal(signal.SIGHUP, _on_hup)
    except (ValueError, AttributeError):
        pass  # non-main thread / platform without SIGHUP

    def on_pass(state):
        if args.debug_fp:
            _check_finite(state.image, f"the pass ending at {state.spp_done} spp")
        now = time.time()
        if flush_req["force"] or now - flush_req["at"] >= args.refresh:
            imagelib.write_image(out, state.image)
            loglib.Log(loglib.EInfo, "flushed partial film (%d/%d spp)",
                       state.spp_done, cfg.spp)
            flush_req["at"] = now
            flush_req["force"] = False

    pass_spp = max(min(cfg.spp // 8, 64), 1)
    state = ckpt.render_progressive(
        scene, cam, li_fn, cfg, total_spp=cfg.spp, pass_spp=pass_spp,
        on_pass=on_pass, progress=not args.quiet)
    return state.image


if __name__ == "__main__":
    sys.exit(main())
