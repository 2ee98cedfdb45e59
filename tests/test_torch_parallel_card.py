"""The slice of the sharded renderer, the dipole, the special functions and
the new warps on the card against the CPU, and a one-rank NCCL group's
sharded renders against common.render. The card's float32 elementwise
functions and the CPU's differ in their last bits
(test_card_elementwise_last_bits prints by how much): values are held at
their CPU parity file's bar, but where a last bit decides a branch
(ROADMAP C44): a bisection's final bracket (2^-16 for
spline_sample), x and y of a direction near the pole (as
tests/test_torch_warp.py), and a single-scatter sample taking the other
connection (at most SSS_FLIP_LANES lanes, each within SSS_FLIP_RTOL).
Imports no JAX, so the card's tests run where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_parallel_card.py
"""
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.core import special, warp
from mitsuba_tpu_torch.integrators import common
from mitsuba_tpu_torch.models import subsurface as sss
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N = 4096
TOL = 1e-6                        # tests/test_torch_special.py, test_torch_warp.py
ULPS = 4                          # tests/test_torch_warp.py
SSS_TOL = 1e-5                    # tests/test_torch_subsurface.py
# lanes of 64 whose 32-sample mean may hold one sample that took the other
# connection (measured on the H100: 2 lanes, 2.45% off)
SSS_FLIP_LANES, SSS_FLIP_RTOL = 4, 0.05
RTOL, ATOL = 1e-4, 1e-5           # tests/test_sharded.py
WARPS = {"uniform_hemisphere": (), "uniform_disk": (), "std_normal": (), "tent": (),
         "beckmann": (0.3,), "ggx": (0.2,), "von_mises_fisher": (8.0,), "phong_lobe": (12.0,)}
PDFS = {"beckmann_pdf": (0.3,), "ggx_pdf": (0.2,), "von_mises_fisher_pdf": (8.0,),
        "phong_lobe_pdf": (12.0,)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(card, cpu, tol):
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=tol, atol=tol)


def _close_dirs(card, cpu):
    """Unit directions: z at TOL, x and y at TOL plus ULPS last bits of z
    carried through sqrt(1 - z^2) (tests/test_torch_warp.py's bar)."""
    card, cpu = card.cpu().numpy(), cpu.numpy()
    np.testing.assert_allclose(card[:, 2], cpu[:, 2], rtol=TOL, atol=TOL)
    eps = ULPS * float(np.finfo(np.float32).eps)
    sin = np.sqrt(np.maximum(1.0 - cpu[:, 2].astype(np.float64) ** 2, eps))
    assert np.all(np.abs(card[:, :2] - cpu[:, :2]).max(-1) <= TOL + eps / sin)


def _dirs(seed, n=N):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))


@pytest.mark.cuda
def test_special_on_card_equals_cpu(cuda):
    d = _dirs(9)
    _close(special.sh_eval(d.to(cuda), 4), special.sh_eval(d, 4), TOL)
    u = torch.as_tensor(np.random.RandomState(4).uniform(0, 1, N).astype(np.float32))
    v = torch.tensor([0.5, 2.0, 1.0, 3.0, 0.75, 1.5, 4.0, 0.2])
    t_card, pdf_card = special.spline_sample(v.to(cuda), u.to(cuda))
    t_cpu, _ = special.spline_sample(v, u)
    # one step of the 16-step bisection may go the other way on a last bit
    gap = (t_card.cpu() - t_cpu).abs()
    print(f"\n[C44] spline_sample: {int((gap > TOL).sum())} of {N} lanes beyond {TOL}, "
          f"lanes {torch.nonzero(gap > TOL).flatten().tolist()[:16]}, "
          f"largest {float(gap.max()) * 2 ** 16:.4f} x 2^-16")
    assert float(gap.max()) <= 2.0 ** -16 + TOL
    _close(pdf_card, special.spline_eval(v, t_card.cpu()) / special.spline_integrate(v)[-1], TOL)

    def f(x):
        return x * x * x - 5.0

    _close(special.brent(f, u.to(cuda) * 0, u.to(cuda) * 0 + 3), special.brent(f, u * 0, u * 0 + 3),
           TOL)


# the largest error in units in the last place of CUDA's single-precision
# functions (the CUDA C++ Programming Guide's table of them), plus one for
# the CPU's own (ATen's vectorized functions are 1-ulp SLEEF variants)
CUDA_ULPS = {"exp": 2, "log": 1, "sqrt": 0, "sin": 2, "cos": 2, "atan2": 3, "acos": 2,
             "pow": 4}


@pytest.mark.cuda
def test_card_elementwise_last_bits(cuda):
    """What C44's bars rest on: the card's float32 elementwise functions
    and the CPU's agree within their documented errors, not bit for bit.
    Prints, for 4,096 inputs each, the lanes whose result differs and the
    largest gap in units in the last place (run with -s)."""
    x = torch.as_tensor(np.random.RandomState(7).uniform(0.01, 4.0, N).astype(np.float32))
    y = torch.as_tensor(np.random.RandomState(8).uniform(-4.0, 4.0, N).astype(np.float32))
    ops = {"exp": lambda a, b: torch.exp(-a), "log": lambda a, b: torch.log(a),
           "sqrt": lambda a, b: torch.sqrt(a), "sin": lambda a, b: torch.sin(b),
           "cos": lambda a, b: torch.cos(b), "atan2": torch.atan2,
           "acos": lambda a, b: torch.acos(b / 4.0), "pow": lambda a, b: torch.pow(a, b)}
    for name, fn in ops.items():
        cpu, card = fn(x, y), fn(x.to(cuda), y.to(cuda)).cpu()
        gap = (card - cpu).abs() / torch.as_tensor(np.spacing(np.abs(cpu.numpy())))
        print(f"\n[C44] {name}: {int((card != cpu).sum())} of {N} lanes differ, "
              f"largest {float(gap.max()):.1f} ulp")
        assert float(gap.max()) <= CUDA_ULPS[name] + 1, name


@pytest.mark.cuda
def test_warps_on_card_equal_cpu(cuda):
    u = torch.as_tensor(np.random.RandomState(5).uniform(0, 1, (N, 2)).astype(np.float32))
    for name, args in WARPS.items():
        fn = getattr(warp, f"square_to_{name}")
        card, cpu = fn(u.to(cuda), *args), fn(u, *args)
        if cpu.shape[-1] == 3:
            _close_dirs(card, cpu)
        else:
            _close(card, cpu, TOL)
    v = _dirs(6)
    for name, args in PDFS.items():
        fn = getattr(warp, f"square_to_{name}")
        _close(fn(v.to(cuda), *args), fn(v, *args), TOL)


def _slab(dev):
    verts = np.asarray([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-0.3, 1.0, -0.3],
                        [0.3, 1.0, -0.3], [0.3, 1.0, 0.3], [-0.3, 1.0, 0.3]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    return ir.build_scene(verts, tris, np.zeros(4, np.int32), [{"type": ir.BSDF_DIFFUSE}],
                          tri_radiance={2: [10.0] * 3, 3: [10.0] * 3}, device=dev)


@pytest.mark.cuda
def test_subsurface_on_card_equals_cpu(cuda):
    """The cache's irradiance (B1), the chunked gather and both
    single-scatter modes on the slab (B1) against the CPU."""
    scene, _ = builtin.cornell_box(device="cpu")
    card, _ = builtin.cornell_box(device=cuda)
    mask = np.zeros(scene.num_triangles, bool)
    mask[10:20] = True
    pts, nrm, area = sss.sample_surface_points(scene, mask, 256)
    cfg = common.RenderConfig(seed=1)
    E = sss.compute_irradiance(scene, pts, nrm, cfg, n_samples=4)
    _close(sss.compute_irradiance(card, pts.to(cuda), nrm.to(cuda), cfg, n_samples=4), E, SSS_TOL)

    def params(dev, sigma_s, sigma_a, eta):
        return sss.DipoleParams(torch.full((3,), sigma_s, device=dev),
                                torch.full((3,), sigma_a, device=dev), g=0.0, eta=eta)

    lo = sss.sss_exitant_radiance(params("cpu", 24.0, 6.0, 1.3), pts, E, area, pts, nrm, nrm)
    _close(sss.sss_exitant_radiance(params(cuda, 24.0, 6.0, 1.3), pts.to(cuda), E.to(cuda), area,
                                    pts.to(cuda), nrm.to(cuda), nrm.to(cuda)), lo, SSS_TOL)
    n = 64
    qp = torch.stack([torch.linspace(-0.4, 0.4, n), torch.zeros(n), torch.zeros(n)], -1)
    ns = torch.tensor([[0.0, 1.0, 0.0]]).repeat(n, 1)
    for exact in (True, False):
        want = sss.single_scatter_radiance(params("cpu", 2.0, 0.2, 1.4), _slab("cpu"), qp, ns, ns,
                                           common.RenderConfig(spp=1, seed=3), n_samples=32,
                                           exact_nee=exact)
        got = sss.single_scatter_radiance(params(cuda, 2.0, 0.2, 1.4), _slab(cuda), qp.to(cuda),
                                          ns.to(cuda), ns.to(cuda),
                                          common.RenderConfig(spp=1, seed=3), n_samples=32,
                                          exact_nee=exact)
        off = ~np.isclose(got.cpu().numpy(), want.numpy(), rtol=SSS_TOL, atol=SSS_TOL).all(-1)
        rel = (got.cpu() - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
        print(f"\n[C44] single_scatter exact_nee={exact}: lanes {np.flatnonzero(off).tolist()} "
              f"off, relative gaps {[round(float(r), 5) for r in rel[torch.as_tensor(off)]]}")
        assert off.sum() <= SSS_FLIP_LANES, off.sum()
        _close(got[torch.as_tensor(off)], want[torch.as_tensor(off)], SSS_FLIP_RTOL)


@pytest.mark.cuda
def test_world_one_nccl_on_card(cuda, tmp_path):
    """A one-rank NCCL group (the rank has its card), mesh (1, 1): the box
    and Gaussian renders equal common.render's; the train step runs."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "card.py"
    script.write_text(textwrap.dedent(f"""\
        import sys
        import torch
        sys.path.insert(0, {str(ROOT)!r})
        from mitsuba_tpu_torch.integrators import common, path
        from mitsuba_tpu_torch.parallel import render_sharded as rs
        from mitsuba_tpu_torch.scene import builtin
        dev, backend = rs.start_group("tcp://127.0.0.1:{port}", 1, 0)
        assert backend == "nccl" and dev.type == "cuda", (backend, dev)
        mesh = rs.make_mesh(1, sp=1)
        scene, cam = builtin.cornell_box(16, 16, device=dev)
        for filt in (0, 2):
            cfg = common.RenderConfig(spp=8, max_depth=3, seed=0, filter=filt)
            a = rs.render_sharded(scene, cam, path.li, cfg, mesh)
            b = common.render(scene, cam, path.li, cfg)
            assert torch.allclose(a, b, rtol={RTOL}, atol={ATOL}), (a - b).abs().max()
        target = torch.full((16, 16, 3), 0.05, device=dev)
        _, loss = rs.train_step(scene, cam, target, path.li,
                                common.RenderConfig(spp=4, max_depth=2, seed=1), mesh, lr=0.1)
        assert torch.isfinite(loss)
        torch.distributed.destroy_process_group()
    """))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
