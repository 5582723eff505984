"""Port parity: quantization, the analog EMT dense layer and the plain
version of the technique-A noisy-matmul kernel (K3) against the JAX
package.

Tolerances: quantized levels are compared exactly.  Layer outputs within
1e-6 relative (float32 matmul order differs between XLA and torch).  aux
energy/reg within rtol 1e-6: both sum |w| over weight-sized reductions in
float32 in different orders.  K3's plain version within 1e-5 relative of
the Pallas kernel in interpret mode (its K-tiled accumulation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import emt_preset as j_emt_preset
from repro.core import emt_linear as jel
from repro.core import quant as jq
from repro.core.quant import QuantConfig as JQC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.common import emt_preset as t_emt_preset
from repro_torch.core import emt_linear as tel
from repro_torch.core import quant as tq
from repro_torch.core import regularizer as treg
from repro_torch.core.quant import QuantConfig as TQC
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import noisy_experts


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [None, -1, (0,)])
def test_quant_levels_and_fake_quant_identical(axis):
    rng = np.random.default_rng(0)
    x = _np(rng, 16, 48)
    x[3, 5] = 0.5 * np.abs(x).max()          # exact half-level ties
    lj, sj = jq.quant_levels(jnp.asarray(x), 8, axis=axis)
    lt, st = tq.quant_levels(torch.from_numpy(x), 8, axis=axis)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    fj, _ = jq.fake_quant(jnp.asarray(x), 8, axis=axis)
    ft, _ = tq.fake_quant(torch.from_numpy(x), 8, axis=axis)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_quantize_weights_identical():
    w = _np(np.random.default_rng(1), 64, 40, scale=0.1)
    wj, _ = jq.quantize_weights(jnp.asarray(w), JQC())
    wt, _ = tq.quantize_weights(torch.from_numpy(w), TQC())
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def _cfgs(mode, a_per_row, accounting="full"):
    jc = j_emt_preset(mode, energy_accounting=accounting)
    tc = t_emt_preset(mode, energy_accounting=accounting)
    if mode != "ideal":
        jc = jc.replace(quant=JQC(a_per_row=a_per_row))
        tc = tc.replace(quant=TQC(a_per_row=a_per_row))
    return jc, tc


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol)


@pytest.mark.parametrize("mode,a_per_row,accounting",
                         [("ideal", False, "full"), ("analog", False, "full"),
                          ("analog", True, "full"), ("analog", True, "off")])
@pytest.mark.parametrize("noise", [True, False])
def test_emt_dense_matches_jax(mode, a_per_row, accounting, noise):
    """noise=False is the noiseless quantized product (xin @ wq); noise=True
    in analog mode goes through K3's wrapper (its plain version on the
    CPU)."""
    rng = np.random.default_rng(2)
    w = _np(rng, 96, 80, scale=0.1)
    x = _np(rng, 3, 5, 96)
    raw = np.float32(treg.rho_init_raw(4.0))
    jc, tc = _cfgs(mode, a_per_row, accounting)
    jc = jc.replace(noise=dataclasses.replace(jc.noise, enabled=noise))
    tc = tc.replace(noise=dataclasses.replace(tc.noise, enabled=noise))
    tag = "dec/layer_001/mlp/wg"
    yj, aj = jel.emt_dense({"w": jnp.asarray(w), "rho_raw": jnp.asarray(raw)},
                           jnp.asarray(x), jc, tag=tag, seed=jnp.uint32(9))
    yt, at = tel.emt_dense({"w": torch.from_numpy(w),
                            "rho_raw": torch.tensor(raw)},
                           torch.from_numpy(x), tc, tag=tag, seed=9)
    assert tel._tag_plane(tag) == jel._tag_plane(tag)
    scale = float(np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-6 * scale)
    for k in ("energy_pj", "reads", "reg", "rho_sum", "kv_reads"):
        _close(float(at[k]), float(aj[k]), 1e-6)
    assert at["cells"] == aj["cells"] and at["rho_layers"] == aj["rho_layers"]
    assert set(at["corners"]) == set(aj["corners"])
    for name, c in aj["corners"].items():
        for k in ("energy_pj", "reads"):
            _close(float(at["corners"][name][k]), float(c[k]), 1e-6)
        assert at["corners"][name]["cells"] == c["cells"]


def test_emt_dense_tied_transposed_weight():
    """The tied unembed passes the table's transpose (a strided view): same
    output as JAX's `tied_table.T`."""
    rng = np.random.default_rng(3)
    table = _np(rng, 200, 48, scale=0.02)
    x = _np(rng, 4, 48)
    raw = np.float32(treg.rho_init_raw(4.0))
    jc, tc = _cfgs("analog", True)
    yj, _ = jel.emt_dense({"w": jnp.asarray(table).T,
                           "rho_raw": jnp.asarray(raw)}, jnp.asarray(x), jc,
                          tag="unembed", seed=jnp.uint32(1))
    yt, _ = tel.emt_dense({"w": torch.from_numpy(table).T,
                           "rho_raw": torch.tensor(raw)},
                          torch.from_numpy(x), tc, tag="unembed", seed=1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-6 * float(np.abs(yj).max()))


@pytest.mark.parametrize("shape", [(8, 256, 384), (5, 130, 200)])
def test_k3_plain_matches_ref_and_interpret_pallas(shape):
    m, kdim, n = shape
    rng = np.random.default_rng(4)
    x, w = _np(rng, m, kdim), _np(rng, kdim, n, scale=0.1)
    rho = np.float32(3.0)
    jdev = j_emt_preset("analog").device
    tdev = t_emt_preset("analog").device
    plane = 1234
    y_ref = np.asarray(jref.emt_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                           rho, device=jdev, seed=17,
                                           plane=plane))
    y_int = np.asarray(jops.emt_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(rho), device=jdev,
                                       seed_static=17, plane=plane,
                                       interpret=True))
    sig = tdev.sigma_rel(torch.tensor(rho))
    y_t = k3.emt_matmul(torch.from_numpy(x), torch.from_numpy(w), sig,
                        device=tdev, seed=17, plane=plane).numpy()
    scale = float(np.abs(y_ref).max())
    np.testing.assert_allclose(y_t, y_ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(y_t, y_int, rtol=0, atol=1e-5 * scale)


def test_k3_noise_independent_of_layout_and_batching():
    """The noisy weight is a function of the logical (row, col) only: a
    strided (transposed) weight, a leading batch shape and any row split
    give the same product as the contiguous call, bit for bit on rows of
    I (each output is one noisy weight element, whatever order BLAS sums
    in), and within float32 summation order on random rows (BLAS sums a
    6-row, a 2-row and a transposed product in different orders, and the
    thread count changes the order too)."""
    rng = np.random.default_rng(5)
    w = _np(rng, 64, 96, scale=0.1)
    dev = t_emt_preset("analog").device
    sig = torch.tensor(0.04)
    wt = torch.from_numpy(w)
    rows = torch.from_numpy(rng.permutation(64)[:6])
    eye = torch.eye(64)[rows]
    xr = torch.from_numpy(_np(rng, 6, 64))

    def variants(xt):
        base = k3.emt_matmul(xt, wt, sig, device=dev, seed=3, plane=8)
        strided = k3.emt_matmul(xt, wt.T.contiguous().T, sig, device=dev,
                                seed=3, plane=8)
        batched = tops.emt_matmul(xt.reshape(2, 3, 64), wt, sig, device=dev,
                                  seed=3, plane=8).reshape(6, 96)
        split = torch.cat([k3.emt_matmul(xt[:2], wt, sig, device=dev,
                                         seed=3, plane=8),
                           k3.emt_matmul(xt[2:], wt, sig, device=dev,
                                         seed=3, plane=8)])
        return base, (strided, batched, split)

    base, others = variants(eye)
    want = noisy_experts(wt[None], sig, device=dev, seed=3, plane=8)[0]
    np.testing.assert_array_equal(base.numpy(), want[rows].numpy())
    for other in others:
        np.testing.assert_array_equal(other.numpy(), base.numpy())
    base, others = variants(xr)
    for other in others:
        np.testing.assert_allclose(other.numpy(), base.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("slab", [1, 21, 45])
def test_k3_plain_noise_slabs_equal_the_whole_weight(slab, monkeypatch):
    """The plain version hashes its noise NOISE_SLAB elements of rows at a
    time (here 1 row; 3 rows of 7, edges 3, 6, 9 of K = 10; 6 rows): the
    offsets, the factors and the noisy weight equal the whole weight's
    hashed at once, bit for bit, on a contiguous and a transposed (tied
    unembed) weight, at a row base, and so does the product."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(9)
    w = torch.from_numpy(_np(rng, 7, 10, scale=0.1)).T     # (10, 7) strided
    x = torch.from_numpy(_np(rng, 3, 10))
    dev = t_emt_preset("analog").device
    sig = torch.tensor(0.04)

    def noise(wt, row0, elems):
        monkeypatch.setattr(tref, "NOISE_SLAB", elems)
        return tref._noise(wt, sig, dev, 5, 3, row0=row0)

    for wt in (w, w.contiguous()):
        for row0 in (0, 4096):
            a0, f0 = noise(wt, row0, 10 * 7)
            a1, f1 = noise(wt, row0, slab)
            np.testing.assert_array_equal(a1.numpy(), a0.numpy())
            np.testing.assert_array_equal(f1.numpy(), f0.numpy())
        _, f0 = noise(wt, 0, 10 * 7)
        monkeypatch.setattr(tref, "NOISE_SLAB", slab)
        wn = tref.noisy_weight(wt, sig, dev, 5, 3)
        np.testing.assert_array_equal(wn.numpy(), (wt * f0).numpy())
        assert wn.stride() == wt.stride()
        np.testing.assert_array_equal(
            tref.emt_matmul_ref(x, wt, sig, device=dev, seed=5,
                                plane=3).numpy(),
            torch.matmul(x, wt * f0).numpy())


def test_emt_config_rejects_unported_modes():
    """bitserial (technique C, kernel K5) and store_int8 are ported (the
    int8 parity tests are tests/test_torch_int8.py); an unknown mode is
    refused."""
    cfg = t_emt_preset("bitserial")
    assert cfg.mode == "bitserial" and cfg.active
    for mode in ("analog", "bitserial"):
        cfg = tel.EMTConfig(mode=mode, store_int8=True)
        assert cfg.store_int8 and set(tel.dense_specs(4, 3, cfg)) == {
            "w_int8", "w_scale", "rho_raw"}
    with pytest.raises(ValueError, match="unknown EMT mode"):
        tel.EMTConfig(mode="digital")


def test_rho_from_raw_matches():
    raws = np.asarray([-3.0, 0.0, treg.rho_init_raw(4.0), 25.0], np.float32)
    from repro.core import regularizer as jreg
    want = np.asarray(jreg.rho_from_raw(jnp.asarray(raws)))
    got = treg.rho_from_raw(torch.from_numpy(raws)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert jax.numpy.float32(treg.rho_init_raw(4.0)) == jreg.rho_init_raw(4.0)
