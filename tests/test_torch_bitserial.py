"""Port parity: technique C (the bit-serial decomposition), the plain
version of the bit-serial kernel (K5) and the bitserial EMT dense layer
against the JAX package.

Tolerances: bit planes and popcounts are compared exactly.  K5's plain
version within 1e-5 relative (to the output's max) of the JAX oracle and of
the Pallas kernel in interpret mode: every plane's noisy weight is
bit-exact, so only the float32 summation order differs.  The layer output
within 1e-5 relative for the same reason, aux energy within rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decompose as jdec
from repro.core import emt_linear as jel
from repro.core.device import DeviceModel as JDev
from repro.core.device import four_state_device as j_four
from repro.core.placement import emt_for_corner as j_corner
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import decompose as tdec
from repro_torch.core import emt_linear as tel
from repro_torch.core import quant as tq
from repro_torch.core import regularizer as treg
from repro_torch.core.device import DeviceModel as TDev
from repro_torch.core.device import four_state_device as t_four
from repro_torch.core.placement import emt_for_corner as t_corner
from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import ops as tops

DEVICES = {"2state": (JDev(), TDev()), "4state": (j_four(), t_four())}


def _levels(rng, m, k, bits):
    """Integer levels in [-(2^bits - 1), 2^bits - 1], as the JAX sweep
    (tests/test_kernels.py) builds them."""
    qmax = 2 ** bits - 1
    x = rng.normal(size=(m, k)).astype(np.float32)
    return np.round(np.clip(x * 20, -qmax, qmax)).astype(np.float32)


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_bit_plane_popcount_and_sigma_ratio_identical():
    """Levels from quant_levels keep the straight-through form x + (q - x),
    which need not be an exact integer in float32: the planes still agree."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 40)).astype(np.float32)
    levels, _ = tq.quant_levels(torch.from_numpy(x), 8, axis=-1)
    mag = np.abs(levels.numpy())
    mag_t = torch.from_numpy(mag)
    for p in range(8):
        np.testing.assert_array_equal(tdec.bit_plane(mag_t, p).numpy(),
                                      np.asarray(jdec.bit_plane(
                                          jnp.asarray(mag), p)))
    np.testing.assert_array_equal(
        tdec.popcount_levels(mag_t, 7).numpy(),
        np.asarray(jdec.popcount_levels(jnp.asarray(mag), 7)))
    ints = np.round(mag)
    np.testing.assert_allclose(
        tdec.sigma_ratio_theory(torch.from_numpy(ints), 7).numpy(),
        np.asarray(jdec.sigma_ratio_theory(jnp.asarray(ints), 7)),
        rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 200, 60)])
@pytest.mark.parametrize("bits", [3, 7])
@pytest.mark.parametrize("devname", ["2state", "4state"])
def test_k5_plain_matches_ref_and_interpret_pallas(m, k, n, bits, devname):
    jdev, tdev = DEVICES[devname]
    rng = np.random.default_rng(m + k + n + bits)
    xq = _levels(rng, m, k, bits)
    w = rng.normal(size=(k, n)).astype(np.float32)
    kw = dict(bits=bits, seed=5, base_plane=11)
    y_ref = jref.emt_bitserial_ref(jnp.asarray(xq), jnp.asarray(w), 4.0,
                                   device=jdev, **kw)
    y_int = jops.emt_bitserial_matmul(jnp.asarray(xq), jnp.asarray(w), 4.0,
                                      device=jdev, interpret=True, **kw)
    sig = tdev.sigma_rel(torch.tensor(4.0))
    y_t = k5.emt_bitserial(torch.from_numpy(xq), torch.from_numpy(w), sig,
                           device=tdev, **kw).numpy()
    _rel_close(y_t, y_ref, 1e-5)
    _rel_close(y_t, y_int, 1e-5)


@pytest.mark.parametrize("seed", [0, 9, 2 ** 32 - 1])
def test_bitserial_matmul_ref_matches_jax_with_runtime_seed(seed):
    """decompose.bitserial_matmul_ref takes the step seed at run time (a
    uint32 array in JAX, as the engine passes it)."""
    rng = np.random.default_rng(1)
    xq = _levels(rng, 2, 6, 7).reshape(2, 6)
    xq = np.stack([xq, -xq])                     # (2, 2, 6) leading dims
    w = rng.normal(size=(6, 10)).astype(np.float32)
    jdev, tdev = DEVICES["2state"]
    want = jdec.bitserial_matmul_ref(jnp.asarray(xq), jnp.asarray(w),
                                     jnp.float32(2.5), jdev, 7,
                                     seed=jnp.uint32(seed), base_plane=300)
    got = tdec.bitserial_matmul_ref(torch.from_numpy(xq), torch.from_numpy(w),
                                    torch.tensor(2.5), tdev, 7, seed=seed,
                                    base_plane=300)
    assert got.shape == (2, 2, 10)
    _rel_close(got.numpy(), want, 1e-5)
    other = tdec.bitserial_matmul_ref(torch.from_numpy(xq),
                                      torch.from_numpy(w), torch.tensor(2.5),
                                      tdev, 7, seed=seed ^ 1, base_plane=300)
    assert not torch.equal(got, other)


def test_k5_independent_of_row_batching_and_weight_layout():
    """Each output row depends only on its own levels: a row split, a
    leading batch shape and a strided weight give the same product.  Rows
    with one nonzero level of at most two set bits sum at most two exact
    terms, so there the products are equal bit for bit whatever the
    summation order; general levels agree to float32 order (1e-6)."""
    rng = np.random.default_rng(2)
    dev = TDev()
    sig = torch.tensor(0.04)
    kw = dict(device=dev, bits=7, seed=3, base_plane=8)
    w = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    sparse = np.zeros((6, 64), np.float32)
    sparse[np.arange(6), [0, 9, 17, 33, 40, 63]] = [1, -2, 3, -5, 64, -96]
    general = _levels(rng, 6, 64, 7)
    for xq, exact in ((sparse, True), (general, False)):
        xq = torch.from_numpy(xq)
        base = k5.emt_bitserial(xq, w, sig, **kw)
        batched = tops.emt_bitserial_matmul(xq.reshape(2, 3, 64), w, sig,
                                            **kw).reshape(6, 96)
        split = torch.cat([k5.emt_bitserial(xq[:1], w, sig, **kw),
                           k5.emt_bitserial(xq[1:4], w, sig, **kw),
                           k5.emt_bitserial(xq[4:], w, sig, **kw)])
        strided = k5.emt_bitserial(xq, w.T.contiguous().T, sig, **kw)
        for other in (batched, split, strided):
            if exact:
                np.testing.assert_array_equal(other.numpy(), base.numpy())
            else:
                _rel_close(other.numpy(), base.numpy(), 1e-6)


@pytest.mark.parametrize("a_per_row", [False, True])
@pytest.mark.parametrize("accounting", ["full", "off"])
def test_emt_dense_bitserial_matches_jax(a_per_row, accounting):
    """The bitserial layer on the RRAM corner, as the mixed placement puts
    every MLP projection: y and aux (energy from the mean popcount, reads,
    cells, the per-corner split)."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(96, 80)) * 0.1).astype(np.float32)
    x = rng.normal(size=(3, 5, 96)).astype(np.float32)
    raw = np.float32(treg.rho_init_raw(4.0))
    jc = j_corner("rram", "bitserial", energy_accounting=accounting)
    tc = t_corner("rram", "bitserial", energy_accounting=accounting)
    jc = jc.replace(quant=dataclasses.replace(jc.quant, a_per_row=a_per_row))
    tc = tc.replace(quant=dataclasses.replace(tc.quant, a_per_row=a_per_row))
    tag = "dec/layer_001/mlp/wd"
    yj, aj = jel.emt_dense({"w": jnp.asarray(w), "rho_raw": jnp.asarray(raw)},
                           jnp.asarray(x), jc, tag=tag, seed=jnp.uint32(9))
    yt, at = tel.emt_dense({"w": torch.from_numpy(w),
                            "rho_raw": torch.tensor(raw)},
                           torch.from_numpy(x), tc, tag=tag, seed=9)
    _rel_close(yt.numpy(), yj, 1e-5)
    for key in ("energy_pj", "reads", "reg", "rho_sum", "kv_reads"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]), rtol=1e-6,
                                   err_msg=key)
    assert at["cells"] == aj["cells"] and at["rho_layers"] == aj["rho_layers"]
    assert set(at["corners"]) == set(aj["corners"]) == {"rram"}
    for key in ("energy_pj", "reads"):
        np.testing.assert_allclose(float(at["corners"]["rram"][key]),
                                   float(aj["corners"]["rram"][key]),
                                   rtol=1e-6, err_msg=key)
    assert at["corners"]["rram"]["cells"] == aj["corners"]["rram"]["cells"]


def test_bitserial_energy_counts_popcount_not_level():
    """Eq. 19: the bit-serial layer bills the mean popcount of the levels,
    below the analog layer's mean level on the same inputs."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(64, 32)) * 0.1).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    p = {"w": torch.from_numpy(w),
         "rho_raw": torch.tensor(np.float32(treg.rho_init_raw(4.0)))}
    bs = t_corner("rram", "bitserial")
    _, a_bs = tel.emt_dense(p, x, bs, tag="t", seed=1)
    _, a_an = tel.emt_dense(p, x, bs.replace(mode="analog"), tag="t", seed=1)
    assert 0 < float(a_bs["energy_pj"]) < float(a_an["energy_pj"])
