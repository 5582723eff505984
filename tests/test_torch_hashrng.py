"""Port parity: counter-hash RNG, RTN state sampling and Gumbel draws of
repro_torch are bit-exact with the JAX package (integer bits and float32
offsets compared with exact equality)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashrng as jh
from repro.core import noise as jnoise
from repro.core.device import DeviceModel as JDev
from repro.core.device import four_state_device as j4
from repro.serve import sampling as jsamp
from repro_torch.core import hashrng as th
from repro_torch.core import noise as tnoise
from repro_torch.core.device import DeviceModel as TDev
from repro_torch.core.device import four_state_device as t4
from repro_torch.serve import sampling as tsamp

DEVICES = [(JDev(), TDev()), (j4(), t4()),
           (JDev(state_offsets=(-2.0, 0.0, 1.0), state_probs=(0.2, 0.3, 0.5)),
            TDev(state_offsets=(-2.0, 0.0, 1.0), state_probs=(0.2, 0.3, 0.5)))]


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


@pytest.mark.parametrize("seed,plane", [(0, 0), (2 ** 32 - 1, 0x7FFFFFF),
                                        (123456789, 0x5A3D17)])
def test_hash_counters_bit_exact(seed, plane):
    rng = np.random.default_rng(seed % 1000)
    rows, cols = _u32(rng, (40, 1)), _u32(rng, (1, 70))
    want = np.asarray(jh.hash_counters(jnp.uint32(seed), jnp.asarray(rows),
                                       jnp.asarray(cols), plane))
    got = th.hash_counters(seed, torch.from_numpy(rows.astype(np.int64)),
                           torch.from_numpy(cols.astype(np.int64)), plane)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_hash_counters_array_seeds_bit_exact():
    rng = np.random.default_rng(7)
    seeds, rows, cols = _u32(rng, (6, 1)), _u32(rng, (6, 1)), _u32(rng, (1, 33))
    want = np.asarray(jh.hash_counters(jnp.asarray(seeds), jnp.asarray(rows),
                                       jnp.asarray(cols), plane=99))
    got = th.hash_counters(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(rows.astype(np.int64)),
                           torch.from_numpy(cols.astype(np.int64)), 99)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("devs", DEVICES, ids=["two", "four", "three"])
@pytest.mark.parametrize("origin", [(0, 0), (5, 1021), (2 ** 31, 7)])
def test_tile_state_offsets_bit_exact(devs, origin):
    jd, td = devs
    assert td.state_offsets == jd.state_offsets
    assert td.state_probs == jd.state_probs
    want = np.asarray(jh.tile_state_offsets(
        11, origin[0], origin[1], (48, 80), jd.state_offsets, jd.state_probs,
        plane=4242))
    got = th.tile_state_offsets(11, origin[0], origin[1], (48, 80),
                                td.state_offsets, td.state_probs, 4242)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("devs", DEVICES[:2], ids=["two", "four"])
def test_bits_to_state_at_threshold_boundaries(devs):
    """uint32 -> float32 rounding and the float32 thresholds decide states
    exactly as JAX does, including bits that round onto a threshold."""
    jd, td = devs
    thr = th.state_thresholds(td.state_probs)
    bits = []
    for t in thr:
        b = int(round(t * 2 ** 32))
        bits += [max(b + d, 0) for d in range(-300, 301, 7)]
    bits = np.asarray(bits, np.uint32)
    want = np.asarray(jh.bits_to_state(jnp.asarray(bits), jd.state_probs))
    got = th.bits_to_state(torch.from_numpy(bits.astype(np.int64)),
                           td.state_probs)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(37,), (24, 40), (3, 16, 24),
                                   (2, 2, 8, 8)])
def test_sample_state_offsets_hash_bit_exact(shape):
    jd, td = DEVICES[1]
    want = np.asarray(jnoise.sample_state_offsets_hash(5, shape, jd,
                                                       plane=321))
    got = tnoise.sample_state_offsets_hash(5, shape, td, plane=321)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_draws_match():
    """The 23-bit uniforms are bit-exact; the Gumbel values agree to float32
    log rounding (XLA's CPU log is a polynomial approximation that differs
    from torch's by an ulp on some inputs), 2e-6 absolute at |g| <= 16."""
    seeds = np.asarray([0, 1, 2 ** 32 - 1, 77], np.uint32)
    pos = np.asarray([0, 5, 3, 1000], np.int32)
    bits = jh.hash_counters(jnp.asarray(seeds)[:, None],
                            jnp.asarray(pos).astype(jnp.uint32)[:, None],
                            jnp.arange(1000, dtype=jnp.uint32)[None, :],
                            plane=jsamp.SAMPLING_PLANE)
    u_want = ((bits >> 9).astype(jnp.float32) + 0.5) * (1.0 / 8388608.0)
    assert tsamp.SAMPLING_PLANE == jsamp.SAMPLING_PLANE
    np.testing.assert_array_equal(
        tsamp.gumbel_uniform(seeds, pos, 1000).numpy(), np.asarray(u_want))
    want = np.asarray(jsamp.gumbel_noise(jnp.asarray(seeds), jnp.asarray(pos),
                                         1000))
    got = tsamp.gumbel_noise(seeds, pos, 1000).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
