"""Port parity: plain versions of the fused paged-decode kernel (K1) and the
paged-prefill kernel (K2) against the JAX package's Pallas kernels in
interpret mode and its jnp references.

Tolerances: attention outputs within 1e-5 absolute (unit-normal inputs;
online vs one-shot softmax and different float32 sum orders).  K/V pools
after the fused write are compared bit for bit.  Mirrors
tests/test_paged_attention.py (fused-write pool bit identity, prefill
parity sweep, chunk-skip boundary).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.common import NEG_INF as J_NEG_INF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels import paged_prefill as k2
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import NEG_INF as T_NEG_INF

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_neg_inf_sentinel_matches():
    assert NEG_INF == T_NEG_INF == J_NEG_INF


def _decode_case(rng, B, KV, G, hd, bs, T, L):
    NB = B * T + 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    kp[NB] = vp[NB] = 0.0
    table = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
    table[:, -1] = NB                        # unallocated tail -> zero block
    wpos = rng.integers(0, (T - 1) * bs, size=B).astype(np.int32)
    mask = np.where(np.arange(L)[None, :] <= wpos[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    mask[1] = NEG_INF                        # fully masked row -> zeros
    active = np.ones(B, bool)
    active[B - 1] = False                    # inactive row: no write
    kn = rng.normal(size=(B, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, hd)).astype(np.float32)
    return q, kp, vp, table, mask, kn, vn, wpos, active


@pytest.mark.parametrize("bs,KV,G,L_short", [(2, 1, 4, 0), (4, 2, 2, 3),
                                             (8, 1, 3, 5), (4, 2, 16, 0),
                                             (4, 1, 5, 3)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_k1_plain_matches_interpret_and_ref(bs, KV, G, L_short, softcap):
    """L_short > 0: mask shorter than the table view (partial last block,
    padded with NEG_INF by the wrapper)."""
    rng = np.random.default_rng(bs * 100 + KV * 10 + G)
    B, T, hd = 4, 5, 16
    L = T * bs - L_short
    q, kp, vp, table, mask, kn, vn, wpos, active = _decode_case(
        rng, B, KV, G, hd, bs, T, L)
    outs = {}
    for impl in ("interpret", "ref"):
        o, kpo, vpo = jops.paged_attention_decode(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(mask), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(wpos), jnp.asarray(active),
            softcap=softcap, impl=impl)
        outs[impl] = (np.asarray(o), np.asarray(kpo), np.asarray(vpo))
    kpt, vpt = _t(kp), _t(vp)
    o, kpt2, vpt2 = tops.paged_attention_decode(
        _t(q), kpt, vpt, _t(table), _t(mask), _t(kn), _t(vn), _t(wpos),
        _t(active), softcap=softcap)
    assert kpt2 is kpt and vpt2 is vpt             # updated in place
    for impl, (oj, kj, vj) in outs.items():
        np.testing.assert_allclose(o.numpy(), oj, rtol=0, atol=ATOL,
                                   err_msg=impl)
        np.testing.assert_array_equal(kpt.numpy(), kj, err_msg=impl)
        np.testing.assert_array_equal(vpt.numpy(), vj, err_msg=impl)
    assert (o.numpy()[1] == 0).all() and np.isfinite(o.numpy()).all()
    assert not np.array_equal(kp, kpt.numpy())     # active rows did write


@pytest.mark.parametrize("G,hd,ok", [(16, 128, True), (5, 128, True),
                                     (2, 256, True), (8, 256, True),
                                     (16, 256, False), (17, 64, False),
                                     (9, 256, False)])
def test_k1_k4_wrapper_group_limit(G, hd, ok):
    """The kernels take any query group up to 16 heads with G * hd <= 2,048
    (llama3-405b's 16 x 128, gemma2-9b's 2 x 256, llama4-scout's 5 x 128)
    and refuse the rest with the limits in the message."""
    B, KV, bs, T = 2, 8, 16, 3
    m = dict(device="meta")
    args = (torch.empty((B, KV, G, hd), **m),
            torch.empty((7, bs, KV, hd), **m),
            torch.empty((7, bs, KV, hd), **m),
            torch.empty((B, T), dtype=torch.int32, **m),
            torch.empty((B, T * bs), **m))
    for what in ("paged_attention_decode", "paged_attention"):
        if ok:
            assert k1.check_shapes(*args, what) == (B, KV, G, hd, bs, T)
            continue
        with pytest.raises(ValueError, match=rf"^{what}: .*\(G <= 16, hd <= "
                                             r"256, G \* hd <= 2048\)"):
            k1.check_shapes(*args, what)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd", [(16, 128), (5, 128), (8, 128), (2, 256)])
def test_k1_k4_cuda_match_plain_at_new_groups(G, hd):
    """On the card: K1 and K4 at the query groups of llama3-405b (16 x
    128), llama4-scout (5), deepseek-67b and qwen2-vl-72b (8) and gemma2-9b
    (2 x 256), softcap 50, on the inputs of the plain-vs-interpret cases
    above, against the plain version in float64 (1e-5; the plain version
    is held to JAX's interpret-mode kernel at these groups on the CPU,
    and JAX is not run on the card): K1's pools bit-identical to the
    plain write, a fully masked row exact zeros, two calls bit-identical;
    K4 leaves the pools as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    rng = np.random.default_rng(G * hd)
    B, KV, bs, T = 4, 8, 16, 5
    q, kp, vp, table, mask, kn, vn, wpos, active = _decode_case(
        rng, B, KV, G, hd, bs, T, T * bs)
    dev = torch.device("cuda")

    def cu(a):
        return _t(a).to(dev)

    kp64, vp64 = _t(kp).double(), _t(vp).double()
    ref, _, _ = tops.paged_attention_decode(
        _t(q).double(), kp64, vp64, _t(table), _t(mask).double(),
        _t(kn).double(), _t(vn).double(), _t(wpos), _t(active),
        softcap=50.0)
    outs = []
    for _ in range(2):
        kpt, vpt = cu(kp), cu(vp)
        o, _, _ = tops.paged_attention_decode(
            cu(q), kpt, vpt, cu(table), cu(mask), cu(kn), cu(vn), cu(wpos),
            cu(active), softcap=50.0)
        outs.append(o.cpu())
    scale = ref.abs().max().item()
    np.testing.assert_allclose(outs[0].double().numpy(), ref.numpy(),
                               rtol=0, atol=ATOL * scale)
    assert torch.equal(outs[0], outs[1])
    assert (outs[0][1] == 0).all()
    assert torch.equal(kpt.cpu().double(), kp64)
    assert torch.equal(vpt.cpu().double(), vp64)
    ref = tops.paged_attention(_t(q).double(), _t(kp).double(),
                               _t(vp).double(), _t(table),
                               _t(mask).double(), softcap=50.0)
    kpt, vpt = cu(kp), cu(vp)
    o = tops.paged_attention(cu(q), kpt, vpt, cu(table), cu(mask),
                             softcap=50.0).cpu()
    np.testing.assert_allclose(o.double().numpy(), ref.numpy(), rtol=0,
                               atol=ATOL * ref.abs().max().item())
    assert (o[1] == 0).all()
    assert torch.equal(kpt.cpu(), _t(kp)) and torch.equal(vpt.cpu(), _t(vp))


def test_k1_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q, kp, vp, table, mask, kn, vn, wpos, active = _decode_case(
        rng, 3, 1, 2, 8, 4, 4, 16)
    bs = 4
    wblk = _t(table)[torch.arange(3), _t(wpos).long() // bs].to(torch.int32)
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(mask), _t(kn), _t(vn), wblk,
            (_t(wpos) % bs).to(torch.int32), _t(active).to(torch.int32))
    before = k1.paged_attention_decode.launches
    out = k1.paged_attention_decode(*args)
    np.testing.assert_array_equal(out.numpy(), k1.plain(*args).numpy())
    assert k1.paged_attention_decode.launches == before   # no kernel on CPU


def _prefill_case(rng, B, KV, G, hd, bs, T, C):
    NB = B * T + 1
    q = rng.normal(size=(B, C, KV * G, hd)).astype(np.float32)
    kp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    kp[NB] = vp[NB] = 0.0
    table = rng.integers(0, NB, size=(B, T)).astype(np.int32)
    table[:, -1] = NB
    ntok = rng.integers(1, C + 1, size=B)
    start = rng.integers(0, T * bs - C, size=B)
    j = np.arange(C)[None, :]
    qpos = (start[:, None] + np.minimum(j, ntok[:, None] - 1)).astype(np.int32)
    return q, kp, vp, table, qpos


@pytest.mark.parametrize("bs,KV,G,C,softcap", [
    (4, 2, 2, 5, 0.0),     # partial blocks: starts/qpos land mid-block
    (8, 1, 3, 4, 30.0),    # softcap before the causal mask
    (2, 2, 1, 6, 0.0),     # tiny blocks: chunk spans many blocks
    (16, 1, 4, 16, 0.0),   # the main path's block/chunk/group shape
])
def test_k2_plain_matches_interpret(bs, KV, G, C, softcap):
    rng = np.random.default_rng(bs * 100 + KV * 10 + G + C)
    q, kp, vp, table, qpos = _prefill_case(rng, 3, KV, G, 16, bs, 5, C)
    y_int = np.asarray(jops.paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(qpos), softcap=softcap, impl="interpret"))
    y_t = tops.paged_prefill(_t(q), _t(kp), _t(vp), _t(table), _t(qpos),
                             softcap=softcap)
    assert tuple(y_t.shape) == y_int.shape
    np.testing.assert_allclose(y_t.numpy(), y_int, rtol=0, atol=ATOL)


def test_k2_chunk_skip_boundary():
    """Rows whose furthest visible position sits at a block edge: blocks past
    qlast are skipped, the boundary block is not."""
    rng = np.random.default_rng(11)
    B, KV, G, hd, bs, T, C = 3, 1, 2, 8, 4, 64, 2
    NB = 300
    q = rng.normal(size=(B, C, KV * G, hd)).astype(np.float32)
    kp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    kp[NB] = vp[NB] = 0.0
    table = rng.integers(0, NB, size=(B, T)).astype(np.int32)
    edge = 8 * bs
    qpos = np.asarray([[edge - 2, edge - 1], [edge - 1, edge],
                       [edge, edge + 1]], np.int32)
    y_int = np.asarray(jops.paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(qpos), impl="interpret"))
    y_t = tops.paged_prefill(_t(q), _t(kp), _t(vp), _t(table), _t(qpos))
    np.testing.assert_allclose(y_t.numpy(), y_int, rtol=0, atol=ATOL)
    # the plain version ignores qlast: skipping past it changes nothing
    qt = _t(q).reshape(B, C, KV, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, C * G, hd)
    qpe = torch.repeat_interleave(_t(qpos), G, dim=1)
    a = k2.plain(qt, _t(kp), _t(vp), _t(table), qpe, qpe.amax(1))
    b = k2.plain(qt, _t(kp), _t(vp), _t(table), qpe, None)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
