"""The port's counter-based RNG must give the JAX package's bits exactly:
every sample of a render is drawn from it, so one differing bit changes
the image."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu_torch.core import rng as trng

torch.set_num_threads(1)

N = 100_000


def _parts(seed):
    rs = np.random.RandomState(seed)
    parts = [rs.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
    # values at and near the top of the uint32 range
    for p in parts:
        p[:64] = np.uint32(2 ** 32 - 1) - np.arange(64, dtype=np.uint32)
    return parts


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_and_uniform_bits(seed):
    parts = _parts(seed)
    j = np.asarray(jrng.hash_u32(*[jnp.asarray(p) for p in parts]))
    t = trng.hash_u32(*[_t(p) for p in parts]).numpy()
    assert np.array_equal(j.astype(np.int64), t)
    ju = np.asarray(jrng.uniform(*[jnp.asarray(p) for p in parts]))
    tu = trng.uniform(*[_t(p) for p in parts]).numpy()
    assert tu.dtype == np.float32
    assert np.array_equal(ju.view(np.int32), tu.view(np.int32))


def test_sample_stream_dims():
    """Static int dims, int32 bounce-counter tensors (as the wavefront
    passes them, negative values wrapping like astype(uint32)) and a
    Python-int seed."""
    seed, pixel, sample, _ = _parts(2)
    js = jrng.SampleStream(jnp.uint32(7), jnp.asarray(pixel), jnp.asarray(sample))
    ts = trng.SampleStream(7, _t(pixel), _t(sample))
    for dim in (0, 5, 4 + 8 * 7 + 6):
        assert np.array_equal(np.asarray(js.at_dim(dim)).view(np.int32),
                              ts.at_dim(dim).numpy().view(np.int32))
    dims = np.random.RandomState(3).randint(-5, 80, N).astype(np.int32)
    assert np.array_equal(
        np.asarray(js.at_dim(jnp.asarray(dims))).view(np.int32),
        ts.at_dim(torch.from_numpy(dims)).numpy().view(np.int32))
    assert np.array_equal(np.asarray(js.next_2d()), ts.next_2d().numpy())


def test_qmc_kinds_raise():
    """Every sampler kind constructs; a kind outside the seven raises at its
    first QMC draw, as the JAX package's sample_dim does."""
    from mitsuba_tpu_torch.samplers import qmc as tq

    z = torch.zeros(1, dtype=torch.int64)
    for kind in tq.SAMPLER_NAMES:
        trng.SampleStream(0, z, z, kind=kind)
    with pytest.raises(ValueError, match="unknown sampler kind 7"):
        trng.SampleStream(0, z, z, kind=7).next_1d()


@pytest.mark.parametrize("kind", range(7))
def test_sample_stream_kinds(kind):
    """SampleStream(kind=k) draws the JAX stream's numbers: qmc.sample_dim
    for Python-int dims (bit for bit where the JAX code is integer
    arithmetic, within 1e-6 elsewhere), the hash for a tensor dim."""
    from mitsuba_tpu.samplers import qmc as jq

    _, pixel, sample, _ = _parts(4)
    pixel, sample = pixel[:4096], sample[:4096]
    js = jrng.SampleStream(jnp.uint32(5), jnp.asarray(pixel), jnp.asarray(sample),
                           kind=kind, spp=64)
    ts = trng.SampleStream(5, _t(pixel), _t(sample), kind=kind, spp=64)
    exact = kind in (jq.SAMPLER_INDEPENDENT, jq.SAMPLER_LD, jq.SAMPLER_SOBOL)
    for _ in range(3):
        j, t = np.asarray(js.next_2d()), ts.next_2d().numpy()
        if exact:
            assert np.array_equal(j.view(np.int32), t.view(np.int32))
        else:
            np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    dims = np.random.RandomState(kind).randint(0, 80, 4096).astype(np.int32)
    assert np.array_equal(np.asarray(js.at_dim(jnp.asarray(dims))).view(np.int32),
                          ts.at_dim(torch.from_numpy(dims)).numpy().view(np.int32))
