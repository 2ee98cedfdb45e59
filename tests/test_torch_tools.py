"""The port's tools on the CPU against the JAX package's:
mitsuba_tpu_torch/io/collada.py and mitsuba_tpu_torch/mtsutil.py.

- `load_dae` bit for bit against the JAX `load_dae` on tests/test_collada.py's
  .dae (Y_UP, Z_UP and X_UP content: vertices, indices, normals, uvs, names);
- `mtsimport`: the scene XML and .serialized it writes byte-equal to the
  JAX tool's, and the scene loaded by the port equal to `ir.from_jax` of the
  JAX load (tests/test_torch_xml.py's `load_both`);
- `tonemap` (sRGB and gamma), `addimages`, `joinrgb` and `rendertime`:
  byte-equal files and the same printed lines as the JAX tools on the same
  inputs;
- `kdbench --cpu -n 4096` runs (the built-in Cornell box through the
  brute-force twin) and prints its rays/s; without a card and without
  --cpu it exits naming --cpu.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from mitsuba_tpu import mtsutil as jmtsutil
from mitsuba_tpu.io import collada as jcollada, image as jimage
from mitsuba_tpu_torch import mtsutil
from mitsuba_tpu_torch.io import collada
from test_collada import DAE
from test_torch_xml import load_both

torch.set_num_threads(1)


def _printed(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return out.getvalue(), res


@pytest.mark.parametrize("up", ["Y_UP", "Z_UP", "X_UP"])
def test_load_dae_matches_jax(tmp_path, up):
    p = tmp_path / "quad.dae"
    p.write_text(DAE.replace("{UP}", up))
    want, got = jcollada.load_dae(p), collada.load_dae(p)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        for field in ("vertices", "indices", "normals", "uvs"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.name == w.name == "Quad"


def test_mtsimport_matches_jax(tmp_path):
    """Both tools on the same .dae: the same files, byte for byte, the same
    line printed but for the output path, and the port's load of its scene
    file equal to the JAX load carried across."""
    dae = tmp_path / "quad.dae"
    dae.write_text(DAE.replace("{UP}", "Z_UP"))
    outs = {}
    for name, fn in (("jax", jmtsutil.tool_mtsimport), ("port", mtsutil.tool_mtsimport)):
        d = tmp_path / name
        d.mkdir()
        printed, _ = _printed(fn, [str(dae), str(d / "scene.xml"), "--fov", "50"])
        outs[name] = (printed.replace(str(d), "<dir>"),
                      (d / "scene.xml").read_bytes(), (d / "scene.serialized").read_bytes())
    assert outs["port"] == outs["jax"]
    assert "imported 1 mesh(es), 2 triangles" in outs["port"][0]
    scene, cam, cfg, integ = load_both(tmp_path / "port" / "scene.xml")
    assert scene.num_triangles == 2 and integ == "path" and scene.has_env
    np.testing.assert_array_equal(scene.vertices.numpy(),
                                  collada.load_dae(dae)[0].vertices)


def _images(d):
    """The tools' inputs, written by the JAX package's writers: name -> path."""
    rs = np.random.default_rng(5)
    paths = {}
    for name, file in (("a", "a.exr"), ("b", "b.pfm"), ("r", "r.exr"), ("g", "g.pfm"),
                       ("bb", "bb.exr")):
        jimage.write_image(d / file, rs.uniform(0, 2, (6, 5, 3)).astype(np.float32))
        paths[name] = str(d / file)
    for name, meta in (("t1", {"renderTime": 3.0, "spp": 64.0}), ("t2", {"renderTime": 12.25}),
                       ("t3", None)):
        jimage.write_exr(d / f"{name}.exr", np.zeros((4, 4, 3), np.float32), metadata=meta)
        paths[name] = str(d / f"{name}.exr")
    return paths


@pytest.mark.parametrize("tool,argv", [
    ("tonemap", ["{a}", "-o", "{out}.png"]),
    ("tonemap", ["{b}", "-o", "{out}.png", "-m", "0.5", "-g", "2.2"]),
    ("addimages", ["{a}", "{b}", "{out}.exr", "--wa", "0.25", "--wb", "2"]),
    ("addimages", ["{a}", "{b}", "{out}.pfm"]),
    ("joinrgb", ["{r}", "{g}", "{bb}", "{out}.exr"]),
    ("rendertime", ["{t1}", "{t2}", "{t3}"]),
])
def test_image_tools_match_jax(tmp_path, tool, argv):
    paths = _images(tmp_path)
    results = {}
    for name, mod in (("jax", jmtsutil), ("port", mtsutil)):
        out = str(tmp_path / f"out_{name}")
        printed, _ = _printed(getattr(mod, f"tool_{tool}"),
                              [a.format(out=out, **paths) for a in argv])
        files = sorted(tmp_path.glob(f"out_{name}.*"))
        results[name] = (printed.replace(out, "<out>"),
                         [(f.suffix, f.read_bytes()) for f in files])
    assert results["port"] == results["jax"]
    if tool == "rendertime":
        assert "3.00 s (64 spp)" in results["port"][0] and "total: 15.25 s" in results["port"][0]
    else:
        assert results["port"][1] and results["port"][0].startswith("wrote")


def test_kdbench_cpu(capsys):
    res = mtsutil.tool_kdbench(["--cpu", "-n", "4096"])
    line = capsys.readouterr().out
    assert "32 triangles, 4096 rays:" in line and "M rays/s" in line
    assert res["triangles"] == 32 and res["rays"] == 4096 and res["rays_per_s"] > 0
    assert mtsutil.main(["kdbench", "--cpu", "-n", "256"]) == 0
    assert mtsutil.main(["no_such_tool"]) == 1


def test_kdbench_rays_cover_the_scene():
    """The rays start on the bounding sphere and are unit vectors, from
    the seeded generator (the same rays on every call)."""
    from mitsuba_tpu_torch.scene import builtin

    scene, _ = builtin.cornell_box(device="cpu")
    o, d = mtsutil.kdbench_rays(scene, 4096)
    o2, d2 = mtsutil.kdbench_rays(scene, 4096)
    assert torch.equal(o, o2) and torch.equal(d, d2)
    lo, hi = scene.vertices.amin(0), scene.vertices.amax(0)
    r = torch.linalg.vector_norm(o - (lo + hi) / 2, dim=-1)
    torch.testing.assert_close(r, torch.full_like(r, float(torch.linalg.vector_norm(hi - lo)) / 2))
    torch.testing.assert_close(torch.linalg.vector_norm(d, dim=-1), torch.ones(4096))


def test_kdbench_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        mtsutil.tool_kdbench(["-n", "256"])
