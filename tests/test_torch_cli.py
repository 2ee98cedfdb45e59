"""The port's command line (mitsuba_tpu_torch/cli.py) on the CPU: against
the JAX package's `cli.main` on the same scene file (the EXR pixels at the
goldens' 1e-4; the statistics and the log lines alike), then the port's
own branches, each against an in-process render of the same loaded scene:
the -s/-d/-t/-D overrides, --integrator, --time-bins, -r progressive,
the tiled film, -j over several scenes, checkpoint resume, --debug-fp,
pssmlt's and erpt's counts, the exits naming ROADMAP A12 and A13, and the
exit without a GPU and --cpu."""
import contextlib
import dataclasses
import functools
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import cli
from mitsuba_tpu_torch.core import logger as loglib
from mitsuba_tpu_torch.integrators import common, direct, path, volpath
from mitsuba_tpu_torch.io import image
from mitsuba_tpu_torch.scene import xml
from mitsuba_tpu_torch.utils import checkpoint, stats

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RENDER_TOL = 1e-4
# film/tiled.py against the full frame (C32)
TILED_RTOL, TILED_ATOL = 1e-5, 1e-6

SCENE = """\
<scene version="0.6.0">
    <default name="res" value="8"/>
    <default name="refl" value="0.6, 0.5, 0.4"/>
    <integrator type="{integrator}"><integer name="maxDepth" value="3"/></integrator>
    <sensor type="perspective">
        <float name="fov" value="39.3077"/>
        <transform name="toWorld">
            <lookat origin="0.5,0.5,-1.3" target="0.5,0.5,0.5" up="0,1,0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
        <film type="{film}">
            <integer name="width" value="$res"/><integer name="height" value="$res"/>
        </film>
    </sensor>
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/><translate x="0.5" z="0.5"/></transform>
        <bsdf type="diffuse"><rgb name="reflectance" value="$refl"/></bsdf>
    </shape>
    <shape type="cube">
        <transform name="toWorld"><scale value="0.15"/><translate x="0.4" y="0.15" z="0.5"/>
            </transform>
        <transform name="toWorldEnd"><scale value="0.15"/><translate x="0.6" y="0.15" z="0.5"/>
            </transform>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="90"/><translate x="0.5" y="1.5" z="0.5"/></transform>
        <emitter type="area"><rgb name="radiance" value="8,8,8"/></emitter>
    </shape>
    {extra}
</scene>
"""


def write_scene(d, name="s.xml", integrator="path", film="hdrfilm", extra=""):
    p = Path(d) / name
    p.write_text(SCENE.format(integrator=integrator, film=film, extra=extra))
    return p


def run(*argv):
    """cli.main on the CPU; returns its exit code."""
    return cli.main([str(a) for a in argv] + ["--cpu"])


def render_loaded(p, li=path.li, defaults=None, time=0.0, **cfg_changes):
    scene, cam, cfg, _ = xml.load_xml(p, defaults=defaults, time=time, device="cpu")
    return common.render(scene, cam, li, dataclasses.replace(cfg, **cfg_changes)).numpy()


@contextlib.contextmanager
def captured(logger):
    """The logger's records as bare messages (no time, no package tag) and
    stderr (where the statistics go), as (log, err) StringIOs."""
    log, err = io.StringIO(), io.StringIO()
    app = loglib.StreamAppender(log)
    fmt = logger.formatter
    logger.add_appender(app)
    logger.formatter = lambda level, msg: msg
    try:
        with contextlib.redirect_stderr(err):
            yield log, err
    finally:
        logger.formatter = fmt
        logger.appenders.remove(app)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's CLI on the scene once (jitted once): its image,
    log lines and statistics."""
    from mitsuba_tpu import cli as jcli
    from mitsuba_tpu.core import logger as jlog
    from mitsuba_tpu.utils import stats as jstats

    d = tmp_path_factory.mktemp("jax_cli")
    p = write_scene(d)
    jstats.get_statistics().reset()
    with captured(jlog.get_logger()) as (log, err):
        jcli.main([str(p), "-o", str(d / "o.exr"), "--cpu"])
    return image.read_exr(d / "o.exr"), log.getvalue(), err.getvalue(), p


def test_cli_matches_jax_cli(tmp_path, jax_run):
    ref, _, _, p = jax_run
    assert run(p, "-o", tmp_path / "o.exr", "-q") == 0
    img = image.read_exr(tmp_path / "o.exr")
    assert img.shape == ref.shape == (8, 8, 3)
    np.testing.assert_allclose(img, ref, rtol=RENDER_TOL, atol=RENDER_TOL)
    attrs = image.read_exr_attrs(tmp_path / "o.exr")
    assert attrs["spp"] == 8.0 and attrs["generatedBy"] == "mitsuba_tpu_torch"
    assert attrs["renderTime"] > 0


def _mask(text, out=None):
    """Log/statistics text with the output path and every number masked."""
    if out is not None:
        text = text.replace(str(out), "<out>")
    return re.sub(r"\d+(\.\d+)?[KMGT]?", "#", text).splitlines()


def test_log_and_statistics_like_jax(tmp_path, jax_run):
    """The same log lines and the JAX package's statistics, numbers
    masked; the port adds its Time group (load, bvh, render)."""
    _, jlog, jerr, p = jax_run
    stats.get_statistics().reset()
    with captured(loglib.get_logger()) as (log, err):
        assert run(p, "-o", tmp_path / "o.exr") == 0
    assert _mask(log.getvalue(), tmp_path / "o.exr") == \
        _mask(jlog, Path(p).parent / "o.exr")
    mine, ref = err.getvalue(), jerr
    time_group = "  * Time:\n      load: # s\n      bvh: # s\n      render: # s\n"
    masked = "\n".join(_mask(mine)) + "\n"
    assert time_group in masked
    assert masked.replace(time_group, "") == "\n".join(_mask(ref)) + "\n"
    st = stats.get_statistics()
    assert st.counter("Scene.triangles").value == 16
    assert st.counter("Time.render").value > 0 and st.counter("Time.bvh").value == 0


def test_overrides(tmp_path):
    """-s, -d, -t and -D: the image equals an in-process render of the
    scene loaded with the same defaults and config."""
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "-s", "4", "-d", "2", "-t", "5",
               "-D", "res=6", "-D", "refl=0.2,0.9,0.3") == 0
    want = render_loaded(p, defaults={"res": "6", "refl": "0.2,0.9,0.3"}, spp=4,
                         max_depth=2, seed=5)
    assert want.shape == (6, 6, 3)
    np.testing.assert_array_equal(image.read_exr(tmp_path / "o.exr"), want)


@pytest.mark.parametrize("name,li", [("direct", direct.li), ("volpath", volpath.li)])
def test_integrator_override(tmp_path, name, li):
    extra = ('<medium type="homogeneous"><rgb name="sigmaS" value="0.3, 0.3, 0.3"/>'
             '<rgb name="sigmaA" value="0.05, 0.05, 0.05"/></medium>'
             if name == "volpath" else "")
    p = write_scene(tmp_path, extra=extra)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", name) == 0
    np.testing.assert_array_equal(image.read_exr(tmp_path / "o.exr"), render_loaded(p, li))


def test_time_bins(tmp_path):
    """--time-bins 2: the mean of the loads at shutter times 1/4 and 3/4,
    each with its own seed (the moving cube)."""
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--time-bins", "2") == 0
    want = (render_loaded(p, time=0.25) + render_loaded(p, time=0.75, seed=7919)) / 2
    np.testing.assert_allclose(image.read_exr(tmp_path / "o.exr"), want, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(render_loaded(p, time=0.25), render_loaded(p, time=0.75))


def test_progressive_equals_one_shot(tmp_path):
    """-r 0: passes of spp // 8 samples, the partial film written after
    each; the final image equals the one-shot render (the passes' sums run
    in another order)."""
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "-r", "0", "--debug-fp") == 0
    np.testing.assert_allclose(image.read_exr(tmp_path / "o.exr"), render_loaded(p),
                               rtol=1e-6, atol=1e-6)
    assert "renderTime" in image.read_exr_attrs(tmp_path / "o.exr")


def test_tiled_film_equals_full_frame(tmp_path):
    p = write_scene(tmp_path, film="tiledhdrfilm")
    assert run(p, "-o", tmp_path / "o.exr", "-q") == 0
    full = render_loaded(write_scene(tmp_path, "full.xml"))
    np.testing.assert_allclose(image.read_exr(tmp_path / "o.exr"), full,
                               rtol=TILED_RTOL, atol=TILED_ATOL)
    assert image.read_exr_attrs(tmp_path / "o.exr")["generatedBy"] == "mitsuba_tpu_torch"


def test_jobs_output_names(tmp_path):
    """-j 2 over two scenes: -o out.exr becomes out_<scene stem>.exr."""
    a = write_scene(tmp_path, "alpha.xml")
    b = write_scene(tmp_path, "beta.xml", integrator="direct")
    assert run(a, b, "-j", "2", "-o", tmp_path / "out.exr", "-q") == 0
    np.testing.assert_array_equal(image.read_exr(tmp_path / "out_alpha.exr"), render_loaded(a))
    np.testing.assert_array_equal(image.read_exr(tmp_path / "out_beta.exr"),
                                  render_loaded(b, direct.li))
    assert cli.multi_output("x/out.png", "dir/s.v2.xml") == "x/out_s.v2.png"


def test_checkpoint_resume(tmp_path):
    """render_progressive interrupted after 4 of 8 spp and resumed from its
    .npz equals the uninterrupted progressive render; a changed config
    restarts."""
    scene, cam, cfg, _ = xml.load_xml(write_scene(tmp_path), device="cpu")
    ck = tmp_path / "ck.npz"
    whole = checkpoint.render_progressive(scene, cam, path.li, cfg, 8, pass_spp=2)
    checkpoint.render_progressive(scene, cam, path.li, cfg, 4, pass_spp=2, checkpoint_path=ck,
                                  timelog_path=tmp_path / "t.txt")
    state = checkpoint.render_progressive(scene, cam, path.li, cfg, 8, pass_spp=2,
                                          checkpoint_path=ck)
    assert state.spp_done == 8
    np.testing.assert_array_equal(state.image, whole.image)
    np.testing.assert_allclose(state.image, render_loaded(tmp_path / "s.xml"), atol=1e-6)
    assert len((tmp_path / "t.txt").read_text().split()) == 2
    other = dataclasses.replace(cfg, max_depth=2)
    st = checkpoint.render_progressive(scene, cam, path.li, other, 2, pass_spp=2,
                                       checkpoint_path=ck)
    assert st.cfg_key == checkpoint.cfg_key(other, cam) and st.spp_done == 2


def test_debug_fp_names_first_bad_pixel(tmp_path, monkeypatch):
    """The full frame, each progressive pass, and each band of the tiled
    film (2-row bands here, so the bad pixel lies in the second band)."""
    from mitsuba_tpu_torch.film import tiled

    p = write_scene(tmp_path)
    real = common.render

    def poisoned(*a, y0=0, rows=None, **kw):
        img = real(*a, y0=y0, rows=rows, **kw)
        for y, x, c, v in ((3, 5, 1, float("nan")), (6, 0, 0, float("inf"))):
            if y0 <= y < y0 + img.shape[0]:
                img[y - y0, x, c] = v
        return img

    monkeypatch.setattr(common, "render", poisoned)
    with pytest.raises(SystemExit, match=r"row 3, column 5"):
        run(p, "-o", tmp_path / "o.exr", "-q", "--debug-fp")
    with pytest.raises(SystemExit, match=r"pass ending at 1 spp .*row 3, column 5"):
        run(p, "-o", tmp_path / "o.exr", "-q", "--debug-fp", "-r", "0")
    monkeypatch.setattr(tiled, "render_tiled",
                        functools.partial(tiled.render_tiled, tile_rows=2))
    tp = write_scene(tmp_path, "t.xml", film="tiledhdrfilm")
    with pytest.raises(SystemExit, match=r"--debug-fp: the image .*row 3, column 5"):
        run(tp, "-o", tmp_path / "t.exr", "-q", "--debug-fp")
    assert run(tp, "-o", tmp_path / "t.exr", "-q") == 0   # unchecked: written
    assert run(p, "-o", tmp_path / "o.exr", "-q") == 0


@pytest.mark.parametrize("argv,roadmap", [
    (["--integrator", "mlt"], "A12"), (["--integrator", "mlt", "-r", "0"], "A12"),
    (["--integrator", "mlt", "--time-bins", "2"], "A12"), (["--mesh", "2,1"], "A13"),
    (["--distributed", "localhost:1234,2,0"], "A13")])
def test_unported_options_exit(tmp_path, argv, roadmap):
    """Each exits before it renders or writes: path-space mlt (the rest of
    A12) whatever render route the other flags pick, and the multi-device
    flags (A13)."""
    p = write_scene(tmp_path)
    with pytest.raises(SystemExit, match=roadmap):
        run(p, "-o", tmp_path / "o.exr", "-q", *argv)
    assert not (tmp_path / "o.exr").exists()


@pytest.mark.parametrize("name", ["pssmlt", "mlt", "erpt"])
def test_unported_integrators_exit(tmp_path, name):
    """Of the JAX CLI's Metropolis integrators, pssmlt and erpt render the
    film themselves now; mlt exits naming A12's remainder (ops/manifold.py
    and integrators/mlt.py)."""
    if name == "mlt":
        with pytest.raises(SystemExit, match="A12: ops/manifold.py and integrators/mlt.py"):
            cli.resolve_integrator(name)
    else:
        assert cli.resolve_integrator(name) == name


@pytest.mark.parametrize("name,spp,steps", [("pssmlt", 16, 64), ("pssmlt", 100, 100),
                                            ("erpt", 16, 64), ("erpt", 100, 100)])
def test_mcmc_integrators_parameters(tmp_path, monkeypatch, name, spp, steps):
    """--integrator pssmlt|erpt calls the port's render with the JAX CLI's
    counts (mitsuba_tpu/cli.py:239-272): n_mutations or chain_length =
    max(spp, 64), the other arguments at their defaults; the image it
    returns is what the CLI writes. The renderer is patched: no render."""
    from mitsuba_tpu_torch.integrators import erpt, pssmlt

    mod, key = {"pssmlt": (pssmlt, "n_mutations"), "erpt": (erpt, "chain_length")}[name]
    calls = []

    def fake(scene, cam, cfg, **kw):
        calls.append((cfg, kw))
        return torch.full((cam.height, cam.width, 3), 0.25)

    monkeypatch.setattr(mod, "render", fake)
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "-s", spp, "--integrator", name) == 0
    (cfg, kw), = calls
    assert kw == {key: steps} and cfg.spp == spp
    img = image.read_exr(tmp_path / "o.exr")
    assert img.shape == (8, 8, 3) and np.all(img == 0.25)


FOG = ('<medium type="homogeneous"><rgb name="sigmaS" value="0.6, 0.6, 0.6"/>'
       '<rgb name="sigmaA" value="0.05, 0.05, 0.05"/></medium>')


def _photon_renders():
    """name -> the in-process render the CLI's --integrator name must give,
    with the JAX CLI's pass counts from cfg.spp (mitsuba_tpu/cli.py:230-265)."""
    from mitsuba_tpu_torch.integrators import bre, irrcache, photonmapper, spectral, sppm

    def sppm_(s, c, k):
        return sppm.render(s, c, k, n_passes=max(k.spp // 4, 1))[0]

    return {"sppm": sppm_, "ppm": sppm_,
            "photonmapper": lambda s, c, k: photonmapper.render(
                s, c, k, n_passes=max(min(k.spp // 4, 16), 1)),
            "bre": bre.render, "irrcache": irrcache.render,
            "spectral": lambda s, c, k: common.render(s, c, spectral.li, k),
            "spectral_path": lambda s, c, k: common.render(s, c, spectral.li, k)}


@pytest.mark.parametrize("name", ["sppm", "ppm", "photonmapper", "bre", "irrcache",
                                  "spectral", "spectral_path"])
def test_photon_and_spectral_integrators(tmp_path, name):
    """--integrator with each name of the photon-mapping and spectral slice
    renders the 8x8 scene (in the fog for bre) at its 8 spp through cli.main
    --cpu: the EXR equals the in-process render of the loaded scene with
    the JAX CLI's pass counts."""
    p = write_scene(tmp_path, extra=FOG if name == "bre" else "")
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", name) == 0
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    want = _photon_renders()[name](scene, cam, cfg).numpy()
    got = image.read_exr(tmp_path / "o.exr")
    assert got.shape == (8, 8, 3) and np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,module,fn", [
    ("bdpt", "bdpt", "li"), ("mybdpt", "bdpt", "li"), ("mybdpt2", "bdpt", "li"),
    ("lvcbpt", "lvcbpt", "li"), ("vpl", "vpl", "li"), ("depth", "aov", "li_depth"),
    ("normal", "aov", "li_normal"), ("field", "aov", "li_normal"), ("ao", "aov", "li_ao"),
    ("motion", "aov", "li_motion")])
def test_bidir_and_aov_integrators(tmp_path, name, module, fn):
    """--integrator with each name of the bidirectional slice: the image
    equals common.render of the loaded scene with that Li function."""
    import importlib

    li = getattr(importlib.import_module(f"mitsuba_tpu_torch.integrators.{module}"), fn)
    assert cli.resolve_integrator(name) is li
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", name) == 0
    np.testing.assert_array_equal(image.read_exr(tmp_path / "o.exr"), render_loaded(p, li))


def test_ptracer_and_multichannel_renderers(tmp_path):
    """ptracer renders the film itself; multichannel writes the
    radiance to the output and each other channel beside it as
    <stem>_<channel>.exr."""
    from mitsuba_tpu_torch.integrators import multichannel, ptracer

    p = write_scene(tmp_path)
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    assert run(p, "-o", tmp_path / "pt.exr", "-q", "--integrator", "ptracer") == 0
    np.testing.assert_array_equal(image.read_exr(tmp_path / "pt.exr"),
                                  ptracer.render(scene, cam, cfg).numpy())
    assert run(p, "-o", tmp_path / "mc.exr", "-q", "--integrator", "multichannel") == 0
    want = multichannel.render(scene, cam, cfg)
    assert sorted(want) == ["albedo", "depth", "normal", "radiance"]
    for ch, img in want.items():
        out = tmp_path / ("mc.exr" if ch == "radiance" else f"mc_{ch}.exr")
        np.testing.assert_array_equal(image.read_exr(out), img.numpy())


def test_no_gpu_without_cpu_flag_exits(tmp_path, monkeypatch):
    """The CLI renders on the card by default: without one, and without
    --cpu, it exits naming --cpu (no silent CPU run)."""
    p = write_scene(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        cli.main([str(p), "-o", str(tmp_path / "o.exr"), "-q"])
    assert not (tmp_path / "o.exr").exists()
    with pytest.raises(SystemExit, match="scene file not found"):
        run(tmp_path / "none.xml", "-q")


def test_python_dash_m(tmp_path):
    """`python -m mitsuba_tpu_torch scene.xml -o out.exr --cpu` renders the
    in-process image; without --cpu (this CPU build of torch has no card)
    it exits non-zero naming --cpu."""
    p = write_scene(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "mitsuba_tpu_torch", str(p), "-o", str(tmp_path / "o.exr")]
    res = subprocess.run(cmd + ["--cpu"], capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr
    assert "wrote" in res.stderr and "Statistics:" in res.stderr
    np.testing.assert_array_equal(image.read_exr(tmp_path / "o.exr"), render_loaded(p))
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, capture_output=True, text=True, env=env)
        assert res.returncode != 0 and "--cpu" in res.stderr
