"""Port parity of the serving engine on two of the architectures the port
gained last, at smoke widths (analog, per-row DAC scale, frozen noise,
float32), JAX's weights carried across by the numpy bridge:

* gemma2-9b: chunked prefill on the paged layout, local layers of window 8
  paging through ring tables that wrap, global layers through the global
  table, attention softcap 50 and final softcap 30;
* qwen2-vl-72b: the legacy bucketed prefill (an M-RoPE stack with the
  "embeds" input kind cannot chunk), prompts served on all-zero
  embeddings as JAX's engine serves them, paged.

JAX's engine runs jitted, its DAC levels recorded by ordered host
callbacks; the port's engine serves JAX's temperature-0 tokens free
running, and its ledgers equal JAX's within rtol 1e-5 (``kv_reads`` 1e-6)
on a run that replays JAX's levels.  deepseek-67b, llama3-405b and
llama4-scout serve on paths these two and the earlier engine tests hold
(global GQA; legacy with embeds; mixture of experts), so they are held at
the model level only (tests/test_torch_archs.py).
"""
import numpy as np
import pytest

from port_parity import jax_levels, port_levels, shared_weights
from repro.core import emt_linear as jel
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.spec import ServeSpec as TSpec

GEMMA2, QWEN2VL = "gemma2-9b", "qwen2-vl-72b"
# max_len 24 and four requests of 9-12 prompt tokens keep JAX's compiles
# few: chunked views of 8 and 16 positions, one legacy bucket (16, each
# prompt left-padded by its own amount) and one legacy decode view
ENGINE = dict(batch_size=3, max_len=24, seed=7, block_size=8, paged=True)


def _spec(mod, arch):
    return mod(arch=arch, mode="analog", a_per_row=True, frozen_noise=True,
               smoke=True)


def _requests(Req):
    rng = np.random.default_rng(3)
    return [Req(prompt=rng.integers(0, 512, plen).astype(np.int32),
                max_new=3 + i % 2, seed=100 + i)
            for i, plen in enumerate([11, 9, 12, 10])]


@pytest.fixture(scope="module", params=[GEMMA2, QWEN2VL])
def served(request):
    """JAX's paged engine (its levels recorded), then the port's, free
    running and replaying them."""
    arch = request.param
    cfg_j = _spec(JSpec, arch).build_config()
    cfg_t = _spec(TSpec, arch).build_config()
    params_j, params_t = shared_weights(cfg_t)
    lv = []
    with jax_levels(jel, lv):
        ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
        runs = {"jax": (ej, ej.serve(_requests(JReq), stagger=2))}
    for replay in (None, lv):
        et = TEng(cfg_t, params_t, fresh_noise=False, device="cpu",
                  **ENGINE)
        with port_levels(tel, [], replay):
            res = et.serve(_requests(TReq), stagger=2)
        runs["replay" if replay is not None else "port"] = (et, res)
    assert not lv                               # every level consumed
    return arch, cfg_t, runs


def test_engine_serves_jax_tokens_and_ledgers(served):
    arch, cfg, runs = served
    ej, rj = runs["jax"]
    et, rt = runs["port"]
    ep, rp = runs["replay"]
    assert et.paged and ej.paged
    assert et.chunked == ej.chunked == (arch == GEMMA2)
    if arch == GEMMA2:
        assert et.ring and cfg.attn_softcap == 50.0 \
            and cfg.final_softcap == 30.0
        assert tlm.ring_layers(cfg, tlm.paged_lens(cfg, ENGINE["max_len"])) \
            == {"layer_000"}
        # prompts past the window of 8: the rings wrap
        assert max(len(r.prompt) for r in _requests(TReq)) > 8
    else:
        assert cfg.rope_type == "mrope" and cfg.input_kind == "embeds"
        assert cfg.mrope_sections == (2, 3, 3)
    for res in (rt, rp):
        assert [r.rid for r in res] == [r.rid for r in rj] == list(range(4))
        for a, b in zip(rj, res):
            np.testing.assert_array_equal(b.tokens, a.tokens,
                                          err_msg=f"rid {a.rid}")
            assert (b.done_reason, b.steps) == (a.done_reason, a.steps)
    for a, b in zip(rj, rp):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    mj, mp = ej.metrics(), ep.metrics()
    for k in ("total_energy_pj", "idle_energy_pj"):
        np.testing.assert_allclose(mp[k], mj[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(mp["kv_reads_total"], mj["kv_reads_total"],
                               rtol=1e-6)
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mp[k] == mj[k], k
    assert set(mp["corner_energy_pj"]) == set(mj["corner_energy_pj"]) \
        == {"analog"}
    np.testing.assert_allclose(mp["corner_energy_pj"]["analog"],
                               mj["corner_energy_pj"]["analog"], rtol=1e-5)
    assert et.energy_conserved(rt) and ep.energy_conserved(rp) \
        and ej.energy_conserved(rj)
    for eng in (et, ep):
        eng.kv.check()
        assert eng.kv.pool_g.num_free == eng.kv.pool_g.num_blocks


def test_mrope_and_embeds_stacks_refuse_chunked_prefill():
    """JAX's refusal, with its message: an M-RoPE or embeds stack keeps
    the legacy path."""
    msgs = []
    for spec, Eng in ((JSpec, JEng), (TSpec, TEng)):
        cfg = _spec(spec, QWEN2VL).build_config()
        for c in (cfg, cfg.replace(rope_type="default"),
                  cfg.replace(input_kind="tokens")):
            with pytest.raises(ValueError) as err:
                Eng(c, None, batch_size=1, max_len=8, chunked_prefill=True,
                    **({} if Eng is JEng else {"device": "cpu"}))
            msgs.append(str(err.value))
    assert len(set(msgs)) == 1, msgs
