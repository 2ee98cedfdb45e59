"""The port's binding of the native C++ components (mitsuba_tpu_torch/native.py,
built from native/*.cpp into mitsuba_tpu_torch/_build/) against the JAX
package's binding of the same sources and against the port's own numpy
code (tests/test_native.py's cases): the OBJ parse and the LBVH build
give equal arrays; io/mesh.load_obj takes the native parse for a file
without usemtl and keeps a file's usemtl groups (the JAX loader drops
them, ROADMAP C43)."""
import numpy as np
import pytest

from mitsuba_tpu import native as jnative
from mitsuba_tpu.io import mesh as jmesh
from mitsuba_tpu.scene import bvh as jbvh
from mitsuba_tpu_torch import native
from mitsuba_tpu_torch.io import mesh
from mitsuba_tpu_torch.scene import bvh

OBJ = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
       "vt 0 0\nvt 1 0\nvt 0 1\n"
       "vn 0 0 1\n"
       "f 1/1/1 2/2/1 3/3/1\n"
       "f 2/2/1 4/1/1 3/3/1\n"
       "f -4/-3/-1 -3/-2/-1 -2/-1/-1\n")
OBJ_GROUPS = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
              "usemtl red\nf 1 2 3\nf 1 3 4\nusemtl white\nf 1 4 5\n")


def _python(monkeypatch, fn, *args):
    """fn(*args) with the port's native library taken away: its numpy
    code."""
    with monkeypatch.context() as m:
        m.setattr(native, "parse_obj", lambda path: None)
        m.setattr(native, "build_lbvh", lambda *a: None)
        return fn(*args)


def test_library_builds_from_the_sources():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libmitsuba_native-")


def test_obj_parse_matches_jax_native_and_python(tmp_path, monkeypatch):
    p = tmp_path / "m.obj"
    p.write_text(OBJ)
    mine, ref = native.parse_obj(p), jnative.parse_obj(str(p))
    assert ref is not None
    for k in ("vertices", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(mine[k], ref[k])
    loaded = mesh.load_obj(p)
    py = _python(monkeypatch, mesh.load_obj, p)
    for k in ("vertices", "indices", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(loaded, k), getattr(py, k))
        np.testing.assert_array_equal(getattr(loaded, k), mine[k])
    assert loaded.face_groups == py.face_groups == [""] * 3


def test_usemtl_file_keeps_its_groups(tmp_path, monkeypatch):
    """A file with usemtl parses in Python: its groups kept, its arrays
    those of the native parse (which keeps none, as the JAX loader's
    result shows)."""
    p = tmp_path / "g.obj"
    p.write_text(OBJ_GROUPS)
    loaded = mesh.load_obj(p)
    assert loaded.face_groups == ["red", "red", "white"]
    nat = native.parse_obj(p)
    np.testing.assert_array_equal(loaded.vertices, nat["vertices"])
    np.testing.assert_array_equal(loaded.indices, nat["indices"])
    assert jmesh.load_obj(p).face_groups is None        # C43
    py = _python(monkeypatch, mesh.load_obj, p)
    assert py.face_groups == loaded.face_groups


def test_missing_or_empty_file(tmp_path):
    assert native.parse_obj(tmp_path / "none.obj") is None
    p = tmp_path / "e.obj"
    p.write_text("# nothing\nv 0 0 0\n")
    assert native.parse_obj(p)["indices"].shape == (0, 3)
    assert mesh.load_obj(p).indices.shape[0] == 0


def _soup(n=777, seed=3):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    verts = np.concatenate([base, base + 0.1, base + 0.2]).astype(np.float32)
    tris = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1).astype(np.int32)
    return verts, tris


@pytest.mark.parametrize("n", [1, 777, 5000])
def test_lbvh_matches_jax_native_and_python(monkeypatch, n):
    verts, tris = _soup(n)
    mine = native.build_lbvh(verts, tris, bvh.LEAF_SIZE)
    ref = jnative.build_lbvh(verts, tris, jbvh.LEAF_SIZE)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    built = bvh.build_bvh(verts, tris, device="cpu")
    py = _python(monkeypatch, bvh.build_bvh, verts, tris, "cpu")
    for k in ("aabb_min", "aabb_max", "miss_link", "tri_order"):
        np.testing.assert_array_equal(getattr(built, k).numpy(), getattr(py, k).numpy())
    np.testing.assert_array_equal(built.aabb_min.numpy(), mine[0])
    assert (built.n_leaves, built.n_internal) == (py.n_leaves, py.n_internal)
