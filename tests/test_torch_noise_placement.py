"""The rest of the EMT core against the JAX package: the threefry noise
backend and the placement dict serialization.

* Threefry cannot match JAX bit for bit (JAX draws
  ``jax.random.categorical`` from a threefry key; the port draws the same
  categorical from a ``torch.Generator``), so its tests hold the marginals
  (every state's frequency within 5 sigma of ``state_probs`` over 10^6
  draws, sigma the binomial standard deviation), determinism (the same
  generator state gives the same noise; the per-layer generator derived
  from it and the plane leaves it untouched), and the reference's error
  without a key, which ``launch.train --rng threefry`` reaches on both
  packages (JAX's train step never sets ``ctx.key``).
* Placement dicts: JSON-equal to JAX's for every corner preset, the EMT
  presets and the placement presets, but for EMTConfig's two TPU kernel
  switches (``use_pallas``, ``pallas_interpret``), which the port has not;
  they round-trip, JAX's dicts load, and a string device names a
  registered corner.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import emt_linear as jel
from repro.core import placement as jpl
from repro_torch.configs import common as tcommon
from repro_torch.core import emt_linear as tel
from repro_torch.core import noise as tnoise
from repro_torch.core import placement as tpl
from repro_torch.core.device import DeviceModel, device_names, \
    four_state_device
from repro_torch.kernels import emt_matmul as k3


@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_threefry_state_marginals(dev):
    """10^6 categorical draws: each state's frequency within 5 sigma of its
    probability; the offsets are the device's normalized table."""
    gen = torch.Generator().manual_seed(123)
    offs = tnoise.sample_state_offsets_threefry(gen, (1000, 1000), dev)
    assert offs.dtype is torch.float32 and offs.shape == (1000, 1000)
    n = offs.numel()
    table = torch.tensor(dev.state_offsets, dtype=torch.float32)
    counted = 0
    for off, p in zip(table, dev.state_probs):
        c = int((offs == off).sum())
        counted += c
        sigma = np.sqrt(n * p * (1 - p))
        assert abs(c - n * p) <= 5 * sigma, (float(off), c, n * p, sigma)
    assert counted == n


def test_threefry_is_deterministic_per_generator_and_plane():
    """The same generator state gives the same noise; fold_in derives a
    per-plane generator without advancing its parent, and other planes or
    other seeds give other noise."""
    dev = four_state_device()

    def draw(seed, plane):
        gen = torch.Generator().manual_seed(seed)
        child = tnoise.fold_in(gen, plane)
        assert torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(seed).get_state())
        return tnoise.sample_state_offsets_threefry(child, (64, 48), dev)

    a = draw(7, 11)
    assert torch.equal(a, draw(7, 11))
    assert not torch.equal(a, draw(7, 12))
    assert not torch.equal(a, draw(8, 11))


def test_threefry_layer_and_its_missing_key():
    """emt_dense on the threefry backend: the noise materialized on the
    layer's generator (fold_in of the caller's and the plane) and
    multiplied with torch.matmul, deterministic per generator, at the
    sigma the hash backend uses; without a key JAX's error, as JAX's own
    layer raises it."""
    cfg_t = tcommon.emt_preset("analog", rng="threefry")
    cfg_j = jcommon.emt_preset("analog", rng="threefry")
    params = tel.dense_specs(32, 24, cfg_t)
    from repro_torch.nn.param import init_params
    p = init_params(params, 0, device="cpu")
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))

    def run(seed):
        return tel.emt_dense(p, x, cfg_t, tag="dec/layer_000/attn/wq",
                             key=torch.Generator().manual_seed(seed))

    (y1, aux1), (y2, _), (y3, _) = run(5), run(5), run(6)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    from repro_torch.core import regularizer
    from repro_torch.core.quant import quant_levels, quantize_weights
    wq, _ = quantize_weights(p["w"], cfg_t.quant)
    levels, scale = quant_levels(x, cfg_t.quant.a_bits)
    layer = tnoise.fold_in(torch.Generator().manual_seed(5),
                           tel._tag_plane("dec/layer_000/attn/wq"))
    want = (levels * scale) @ tnoise.fluctuate(
        wq, regularizer.rho_from_raw(p["rho_raw"]), cfg_t.device,
        cfg_t.noise, key=layer)
    assert torch.equal(y1, want)
    # the energy ledger does not depend on the backend
    _, aux_h = tel.emt_dense(p, x, tcommon.emt_preset("analog"),
                             tag="dec/layer_000/attn/wq")
    assert float(aux1["energy_pj"]) == float(aux_h["energy_pj"])
    with pytest.raises(ValueError, match="threefry backend needs a PRNG key"):
        tel.emt_dense(p, x, cfg_t, tag="t")
    pj = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), p)
    with pytest.raises(ValueError, match="threefry backend needs a PRNG key"):
        jel.emt_dense(pj, jax.numpy.asarray(x.numpy()), cfg_j, tag="t")


def test_train_launcher_threefry_raises_the_references_error(tmp_path):
    """JAX's train step has no key to give (repro/train/step.py:74): its
    first traced step raises, and so does the port's launcher."""
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.nn.param import init_params
    from repro.train import step as jstep
    from repro_torch.launch import train as tlaunch
    cfg = jget("gemma3-1b", rng="threefry", smoke=True).replace(
        num_layers=2, dtype=jax.numpy.float32)
    train_step, opt = jstep.make_train_step(cfg, jstep.TrainConfig(), None)
    params = init_params(jlm.specs(cfg), jax.random.PRNGKey(0))
    state = {"params": params, "opt": opt.init(params),
             "step": jax.numpy.zeros((), jax.numpy.int32)}
    toks = jax.numpy.zeros((1, 8), jax.numpy.int32)
    with pytest.raises(ValueError, match="threefry backend needs a PRNG key"):
        train_step(state, {"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match="threefry backend needs a PRNG key"):
        tlaunch.main(["--smoke", "--steps", "1", "--batch", "1", "--seq",
                      "8", "--rng", "threefry", "--ckpt-dir",
                      str(tmp_path)],
                     torch_device="cpu")


def _strip(d):
    """A JAX dict without the TPU kernel switches, as JSON."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()
                    if k not in tpl.TPU_ONLY_EMT_KEYS}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return json.dumps(walk(d), sort_keys=True)


def _emt_pairs():
    """(name, JAX config, port config) for every preset the dicts carry."""
    out = []
    for mode in ("ideal", "analog", "bitserial"):
        out.append((f"emt_preset/{mode}", jcommon.emt_preset(mode),
                    tcommon.emt_preset(mode)))
    out.append(("emt_preset/int8", jcommon.emt_preset(store_int8=True),
                tcommon.emt_preset(store_int8=True)))
    out.append(("emt_preset/threefry", jcommon.emt_preset(rng="threefry"),
                tcommon.emt_preset(rng="threefry")))
    for corner in device_names():
        for mode in ("analog", "bitserial", "ideal"):
            out.append((f"{corner}/{mode}", jpl.emt_for_corner(corner, mode),
                        tpl.emt_for_corner(corner, mode)))
    return out


@pytest.mark.parametrize("name,jc,tc", _emt_pairs(),
                         ids=[n for n, *_ in _emt_pairs()])
def test_emt_dicts_json_equal_and_round_trip(name, jc, tc):
    dj, dt = jpl.emt_to_dict(jc), tpl.emt_to_dict(tc)
    assert json.dumps(dt, sort_keys=True) == _strip(dj)
    assert tpl.emt_from_dict(json.loads(json.dumps(dt))) == tc
    assert tpl.emt_from_dict(json.loads(json.dumps(dj))) == tc


@pytest.mark.parametrize("name", ["mixed", "attn-pcm", "digital-router"])
def test_placement_dicts_json_equal_and_round_trip(name):
    pj = jcommon.placement_preset(name)
    pt = tcommon.placement_preset(name)
    dj, dt = jpl.placement_to_dict(pj), tpl.placement_to_dict(pt)
    assert json.dumps(dt, sort_keys=True) == _strip(dj)
    back = tpl.placement_from_dict(json.loads(json.dumps(dt)))
    assert back == pt and tpl.placement_to_dict(back) == dt
    assert tpl.placement_from_dict(json.loads(json.dumps(dj))) == pt
    # a single EMTConfig serializes as a zero-rule placement
    d1 = tpl.placement_to_dict(tcommon.emt_preset("analog"))
    assert d1["rules"] == [] and json.dumps(d1, sort_keys=True) == _strip(
        jpl.placement_to_dict(jcommon.emt_preset("analog")))


def test_dict_device_by_name_and_unknown_fields():
    """A string device names a registered corner (KeyError if unknown); an
    unknown DeviceModel field is refused; the int8 flag survives."""
    d = tpl.emt_to_dict(tpl.emt_for_corner("rram", store_int8=True))
    d["device"] = "rram"
    got = tpl.emt_from_dict(d)
    assert got.device == tpl.get_device("rram") and got.store_int8
    assert jpl.emt_from_dict(dict(d)).device == jpl.get_device("rram")
    with pytest.raises(KeyError):
        tpl.emt_from_dict(dict(d, device="no-such-corner"))
    dev = tpl.device_to_dict(DeviceModel())
    with pytest.raises(ValueError, match="unknown DeviceModel fields"):
        tpl.device_from_dict(dict(dev, flux=1.0))
    assert tpl.device_from_dict(dev) == DeviceModel()


def test_threefry_never_reaches_the_kernel():
    """The threefry backend multiplies its materialized noise with
    torch.matmul; K3's wrapper is not called."""
    cfg = tcommon.emt_preset("analog", rng="threefry")
    from repro_torch.nn.param import init_params
    p = init_params(tel.dense_specs(16, 8, cfg), 0, device="cpu")
    calls = []
    orig = k3.plain

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    k3.plain = spy
    try:
        tel.emt_dense(p, torch.ones((2, 16)), cfg, tag="t",
                      key=torch.Generator().manual_seed(0))
    finally:
        k3.plain = orig
    assert not calls
