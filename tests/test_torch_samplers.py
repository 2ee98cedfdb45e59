"""The port's samplers (mitsuba_tpu_torch/samplers) against the JAX
package's on the same numpy-seeded pixels and sample indices: every kind
at dimensions on both sides of each wrap (Halton and Hammersley modulo 64,
Sobol' modulo 1,024, Faure modulo 16) and at the boundary and lookahead
bases 1,024, 2,048 and 4,096. The tables are the JAX package's, and the
vectorised bit loops equal literal loops."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.samplers import qmc as jq, sobol as jsobol
from mitsuba_tpu_torch.samplers import qmc as tq, sobol as tsobol

torch.set_num_threads(1)

N = 4096
DIMS = (0, 1, 5, 63, 64, 511, 1023, 1024, 2048, 4096)
# bit for bit where the JAX code is integer arithmetic end to end
EXACT = (tq.SAMPLER_INDEPENDENT, tq.SAMPLER_LD, tq.SAMPLER_SOBOL)
# elsewhere a float32 sum order may move the last bit, and a rotation
# mod 1 may then wrap a lane from ~1 to ~0: such lanes are counted apart
ATOL = 1e-6
MAX_WRAP_SHARE = 1e-4


def _indices(seed):
    rs = np.random.RandomState(seed)
    pixel = rs.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    sample = rs.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    sample[:1024] = np.arange(1024)          # the indices a render uses
    sample[1024:1088] = np.uint32(2 ** 32 - 1) - np.arange(64, dtype=np.uint32)
    return pixel, sample


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("kind", sorted(tq.SAMPLER_NAMES), ids=lambda k: tq.SAMPLER_NAMES[k])
def test_sample_dim_matches_jax(kind):
    pixel, sample = _indices(kind)
    wraps = 0
    for dim in DIMS:
        j = np.asarray(jq.sample_dim(kind, jnp.uint32(11), jnp.asarray(pixel),
                                     jnp.asarray(sample), dim, 16))
        t = tq.sample_dim(kind, 11, _t(pixel), _t(sample), dim, 16).numpy()
        assert t.dtype == np.float32 and t.shape == (N,)
        assert ((t >= 0.0) & (t < 1.0)).all(), dim
        if kind in EXACT:
            assert np.array_equal(j.view(np.int32), t.view(np.int32)), dim
            continue
        diff = np.abs(j - t)
        wrap = (diff > 0.5) & (1.0 - diff <= ATOL)
        wraps += int(wrap.sum())
        assert (diff[~wrap] <= ATOL).all(), (dim, float(diff[~wrap].max()))
    assert wraps <= MAX_WRAP_SHARE * N * len(DIMS), wraps


def test_radical_inverse_and_pair():
    """The module's public primitives against the JAX ones."""
    _, sample = _indices(7)
    js = jnp.asarray(sample)
    for base in (2, 3, 17, 311):
        j = np.asarray(jq.radical_inverse(jnp.uint32(base), js))
        t = tq.radical_inverse(base, _t(sample)).numpy()
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    scramble = _indices(8)[0]
    for jf, tf in ((jq.van_der_corput, tq.van_der_corput), (jq.sobol2, tq.sobol2)):
        j = np.asarray(jf(js, jnp.asarray(scramble)))
        assert np.array_equal(j, tf(_t(sample), _t(scramble)).numpy())
    assert np.array_equal(np.asarray(jq.radical_inverse_base2(js)),
                          tq.radical_inverse_base2(_t(sample)).numpy())


def test_tables_match_jax(monkeypatch):
    """The Sobol' table read in place, the constructed fallback (without
    the data file) and the Faure matrices equal the JAX package's."""
    assert np.array_equal(tsobol.direction_numbers(), jsobol.direction_numbers())
    assert tsobol.direction_numbers().shape == (tsobol.SOBOL_DIMS, 32)
    for mod in (tsobol, jsobol):
        monkeypatch.setattr(mod, "_DIRS_NPZ", "/nonexistent/sobol_dirs.npz")
    built = tsobol.direction_numbers.__wrapped__(96)
    assert np.array_equal(built, jsobol.direction_numbers.__wrapped__(96))
    assert tsobol._primitive_polys(40) == jsobol._primitive_polys(40)
    tb, tm = tsobol.faure_tables(16)
    jb, jm = jsobol.faure_tables(16)
    assert tb == jb == 17 and np.array_equal(tm, jm)
    assert np.array_equal(tq._PRIMES, jq._PRIMES)


def test_bit_loops_match_literal_loops():
    """xor_select (the (N, 32) mask and 5-level XOR tree) against the JAX
    package's 32-step loops in numpy: the Sobol' row loop (qmc.py:161-169)
    and sobol2's, whose direction numbers it generates as it goes
    (qmc.py:62-73). The digit tables of radical_inverse against its
    20-step loop (qmc.py:95-104), which sums in another order: two float32
    ulps at 1 at most."""
    _, sample = _indices(9)
    n = sample.astype(np.uint64)
    shifts = torch.arange(32)
    row = tsobol.direction_numbers()[37].astype(np.uint64)
    ref, nn = np.zeros(N, np.uint64), n.copy()
    for i in range(32):
        ref = np.where(nn & np.uint64(1), ref ^ row[i], ref)
        nn >>= np.uint64(1)
    assert np.array_equal(tq.xor_select(_t(sample), _t(row), shifts).numpy(),
                          ref.astype(np.int64))
    ref, nn, v = np.zeros(N, np.uint64), n.copy(), np.full(N, 1 << 31, np.uint64)
    for _ in range(32):
        ref = np.where(nn & np.uint64(1), ref ^ v, ref)
        v = v ^ (v >> np.uint64(1))
        nn >>= np.uint64(1)
    assert np.array_equal(tq.xor_select(_t(sample), _t(tq._sobol2_row()), shifts).numpy(),
                          ref.astype(np.int64))
    for base in (2, 3, 5, 311):
        nn = n.copy()
        value = np.zeros(N, np.float32)
        inv_base = np.float32(1.0) / np.float32(base)
        inv = np.full(N, inv_base, np.float32)
        for _ in range(20):
            value = value + (nn % np.uint64(base)).astype(np.float32) * inv
            nn //= np.uint64(base)
            inv = inv * inv_base
        ref = np.minimum(value, np.float32(1.0 - 1e-7))
        got = tq.radical_inverse(base, _t(sample)).numpy()
        np.testing.assert_allclose(got, ref, atol=2.0 ** -22, rtol=0)


def test_wavefront_requires_independent_sampler():
    """The wavefront's bounce dims depend on each lane's data, so it draws by
    hashing; the port refuses a QMC kind there instead of ignoring it."""
    from mitsuba_tpu_torch.integrators import common, wavefront
    from mitsuba_tpu_torch.scene import builtin

    scene, cam = builtin.cornell_box(4, 4, device="cpu")
    with pytest.raises(ValueError, match="independent sampler"):
        wavefront.render(scene, cam, common.RenderConfig(spp=1, sampler=tq.SAMPLER_SOBOL))
