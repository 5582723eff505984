"""The port's CUDA kernels against their plain versions on the card, at
small shapes, and the shrunk engines on the card (gemma3-1b analog and on
the mixed placement; seamless-m4t-medium through the legacy prefill and
the cross-attention kernel).  Marked ``gpu``: the fixture skips them
where torch sees no CUDA device; on a machine with an H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 1e-5 relative (float32 sum order; the attention kernels K1,
K2 and K4 against their plain versions in float64); pools after the fused
write (and the read-only kernel's, unchanged), the noisy weight itself
(x = I) and two calls of the split kernels (K1, K2, K3, K4, K5) on the same
inputs bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import noise
from repro_torch.core.device import DeviceModel, four_state_device
from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels import paged_attention as k4
from repro_torch.kernels import paged_prefill as k2
from repro_torch.kernels.ref import NEG_INF

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# (M, K, N, transposed): every GEMV row template (1-4, 8, 16) and the tiled
# kernel (M > 16); K a multiple of neither the K chunk nor the split; both
# weight layouts; ragged N (row strides that allow 16-, 8- and 4-byte loads);
# most cases split K (the plan's split count is printed on failure).
K3_CASES = [(4, 96, 200, False), (64, 256, 130, False), (3, 64, 300, True),
            (1, 1000, 260, False), (2, 555, 1001, False),
            (4, 1000, 262, True), (6, 4100, 64, True),
            (16, 777, 514, False), (16, 300, 200, True),
            (17, 1000, 130, False), (64, 1000, 300, True)]


@pytest.mark.parametrize("M,K,N,transposed", K3_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_matches_plain_and_noise_bit_exact(cuda, M, K, N, transposed, dev):
    """Within 1e-5 of the plain version; two calls bit-identical (the split
    sum is ordered); rows of I give the noisy weight's rows bit for bit on
    the path M selects, and I itself (the tiled path) the whole of it."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda)
    w = torch.randn((N, K) if transposed else (K, N), generator=g,
                    device=cuda)
    w = w.T if transposed else w
    rho = torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    p = k3.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, not transposed)
    kw = dict(device=dev, seed=99, plane=1234)
    before = k3.emt_matmul.launches
    y = k3.emt_matmul(x, w, sig, **kw)
    assert k3.emt_matmul.launches == before + 1
    assert _rel(y, k3.plain(x, w, sig, **kw)) <= 1e-5, p
    assert torch.equal(y, k3.emt_matmul(x, w, sig, **kw)), p
    ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=99,
                          plane=1234)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    eye = torch.eye(K, device=cuda)
    assert torch.equal(k3.emt_matmul(eye[rows], w, sig, **kw), ref[rows]), p
    assert torch.equal(k3.emt_matmul(eye, w, sig, **kw), ref)


# (M, K, N, transposed): every GEMV row template (1-4, 8, 16) and the tiled
# kernel (17, 64); both weight layouts; ragged N; K split into slabs (1024
# with N = 130 on the tiled path, 4100 on the GEMV path).
K5_CASES = [(4, 96, 200, False), (64, 1024, 130, False), (3, 64, 300, True),
            (1, 1000, 260, False), (2, 555, 1001, False),
            (4, 1000, 262, True), (8, 4100, 130, False), (8, 700, 96, True),
            (16, 777, 514, False), (16, 300, 200, True),
            (17, 1000, 130, False), (64, 1000, 300, True)]


@pytest.mark.parametrize("M,K,N,transposed", K5_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k5_matches_plain_and_planes_bit_exact(cuda, M, K, N, transposed,
                                               dev):
    """Within 1e-5 of the plain version; two calls bit-identical (the split
    sum is ordered).  The levels hold an all-zero row (exact zeros out), a
    row whose high planes are zero and a band of K zero in every row.
    Levels 2^p on rows of the identity (the path M
    selects) and on the identity itself (the tiled path) return 2^p times
    plane p's noisy weight, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    xq = torch.round(torch.randn((M, K), generator=g, device=cuda) * 40)
    xq = xq.clamp(-127, 127)
    xq[:, K // 3:K // 2] = 0.0
    if M > 1:
        xq[0] = 0.0
        xq[1] = xq[1].clamp(-15, 15)
    w = torch.randn((N, K) if transposed else (K, N), generator=g,
                    device=cuda)
    w = w.T if transposed else w
    rho = torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    p = k5.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, not transposed)
    kw = dict(device=dev, bits=7, seed=99, base_plane=1234)
    before = k5.emt_bitserial.launches
    y = k5.emt_bitserial(xq, w, sig, **kw)
    assert k5.emt_bitserial.launches == before + 1
    assert _rel(y, k5.plain(xq, w, sig, **kw)) <= 1e-5, p
    assert torch.equal(y, k5.emt_bitserial(xq, w, sig, **kw)), p
    if M > 1:
        assert (y[0] == 0).all()
    eye = torch.eye(K, device=cuda)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    for pl in range(7):
        ref = noise.fluctuate(w, rho, dev, noise.NoiseConfig(), seed=99,
                              plane=1234 + pl) * 2.0 ** pl
        wn = k5.emt_bitserial(eye[rows] * 2.0 ** pl, w, sig, **kw)
        assert torch.equal(wn, ref[rows]), (pl, p)
        assert torch.equal(k5.emt_bitserial(eye * 2.0 ** pl, w, sig, **kw),
                           ref), pl


def _bits_equal(a, b):
    """The same float32 bits (NaN payloads included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k1_matches_plain_and_pools_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, KV, G, hd, bs, T = 3, 2, 4, 64, 8, 5
    nb = B * T + 1
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    wpos = torch.tensor([3, 17, 30], device=cuda)
    mask = torch.where(torch.arange(T * bs - 3, device=cuda)[None, :]
                       <= wpos[:, None], 0.0, NEG_INF)
    mask[1] = NEG_INF
    active = torch.tensor([True, False, True], device=cuda)
    kn = torch.randn((B, KV, hd), generator=g, device=cuda)
    vn = torch.randn((B, KV, hd), generator=g, device=cuda)
    # the plain version in float64 (float32 on the CPU of the machine that
    # holds the H100 is not reproducible across processes: PERF.md, ROADMAP
    # Queue 3); its pools, written in float64, hold the same values
    kpc, vpc = kp.cpu().double(), vp.cpu().double()
    out, _, _ = ops.paged_attention_decode(q, kp, vp, table, mask, kn, vn,
                                           wpos, active, softcap=30.0)
    ref, _, _ = ops.paged_attention_decode(
        q.cpu().double(), kpc, vpc, table.cpu(), mask.cpu().double(),
        kn.cpu().double(), vn.cpu().double(), wpos.cpu(), active.cpu(),
        softcap=30.0)
    torch.cuda.synchronize()
    assert _rel(out.cpu().double(), ref) <= 1e-5
    assert (out[1] == 0).all()
    assert torch.equal(kp.cpu().double(), kpc)
    assert torch.equal(vp.cpu().double(), vpc)


@pytest.mark.parametrize("KV,G,hd", [(16, 1, 64), (1, 4, 256)])
def test_k4_matches_plain_and_only_reads(cuda, KV, G, hd):
    """Rows of encoder length 0 (exact zeros), 1, a partial last block and
    the whole view; the mask is shorter than the view (the wrapper pads
    it).  The plain version runs in float64."""
    g = torch.Generator(device=cuda).manual_seed(KV + G)
    B, bs, T = 4, 16, 3
    nb = B * T + 1
    L = T * bs - 5
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    table[1, 1:] = nb
    lens = torch.tensor([0, 1, 21, L], device=cuda)
    mask = torch.where(torch.arange(L, device=cuda)[None, :] < lens[:, None],
                       0.0, NEG_INF)
    kp0, vp0 = kp.clone(), vp.clone()
    before = k4.paged_attention.launches
    out = ops.paged_attention(q, kp, vp, table, mask)
    assert k4.paged_attention.launches == before + 1
    ref = ops.paged_attention(q.cpu().double(), kp.cpu().double(),
                              vp.cpu().double(), table.cpu(),
                              mask.cpu().double())
    torch.cuda.synchronize()
    assert _rel(out.cpu().double(), ref) <= 1e-5
    assert (out[0] == 0).all()
    assert torch.equal(kp, kp0) and torch.equal(vp, vp0)


# (KV, G, hd, softcap, bs): gemma3-1b's decode attention and seamless-m4t-
# medium's self and cross attention (block 16, batch 4), then a head size
# that rules out 16-byte copies with an odd block, and 8 query heads with
# blocks walked in two chunks; T from 1 to 128 blocks gives every cluster
# size the planner picks (1, 2, 4, 8).
ATTN_SHAPES = [(1, 4, 256, 0.0, 16), (16, 1, 64, 30.0, 16),
               (2, 3, 98, 0.0, 5), (1, 8, 256, 20.0, 32)]


@pytest.mark.parametrize("KV,G,hd,softcap,bs", ATTN_SHAPES)
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16, 128])
@pytest.mark.parametrize("write", [True, False], ids=["k1", "k4"])
def test_k1_k4_cluster_walk(cuda, KV, G, hd, softcap, bs, T, write):
    """The walk split over a cluster, against the float64 plain version at
    1e-5.  Row 0 sees every position up to a write in its last block; row 1
    the same with its second block fully masked between visible ones (for
    T >= 2 one of the two writes lands in a block that a rank other than 0
    walks); row 2 nothing (exact zeros, its write still
    lands); row 3 one block and a bit, with no write.  Blocks that only
    masked positions cover hold NaN: the kernel neither loads nor computes
    them, so it returns the same bits as on clean pools.  K1's pools end
    bit-identical to the plain write's; K4's are untouched.  Two calls give
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(T + KV + G + write)
    B = 4
    L = T * bs
    nb = B * T + 1
    S = k1.kv_splits(B, KV, G, hd, T, torch.cuda.get_device_properties(cuda)
                     .multi_processor_count)
    q = torch.randn((B, KV, G, hd), generator=gen, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=gen, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=gen, device=cuda)
    kp[nb] = vp[nb] = 0.0
    table = torch.randperm(nb, generator=gen, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    wpos = torch.tensor([L - 3, L - 1, min(L - 1, 5), min(L - 1, bs + 2)],
                        device=cuda)
    pos = torch.arange(L, device=cuda)[None, :]
    mask = torch.where(pos <= wpos[:, None], 0.0, NEG_INF)
    if T >= 3:
        mask[1, bs:2 * bs] = NEG_INF
    mask[2] = NEG_INF
    kn = torch.randn((B, KV, hd), generator=gen, device=cuda)
    vn = torch.randn((B, KV, hd), generator=gen, device=cuda)
    active = torch.tensor([True, True, True, False], device=cuda)
    # NaN in every block no row sees (the plain version gets zeros there)
    kpz, vpz = kp.clone(), vp.clone()
    seen = (mask.reshape(B, T, bs) > NEG_INF / 2).any(-1)
    for b in range(B):
        for t in range(T):
            if not seen[b, t]:
                blk = int(table[b, t])
                kp[blk] = vp[blk] = float("nan")
                kpz[blk] = vpz[blk] = 0.0
    kpn, vpn = kp.clone(), vp.clone()
    args64 = (q.cpu().double(), kpz.cpu().double(), vpz.cpu().double(),
              table.cpu(), mask.cpu().double())
    if write:
        outs = [ops.paged_attention_decode(q, kp, vp, table, mask, kn, vn,
                                           wpos, active,
                                           softcap=softcap)[0]
                for _ in range(2)]
        clean = ops.paged_attention_decode(q, kpz, vpz, table, mask, kn, vn,
                                           wpos, active, softcap=softcap)[0]
        ref = ops.paged_attention_decode(
            *args64, kn.cpu().double(), vn.cpu().double(), wpos.cpu(),
            active.cpu(), softcap=softcap)[0]
        plain_k, plain_v = kpn.cpu(), vpn.cpu()
        ops.paged_attention_decode(q.cpu(), plain_k, plain_v, table.cpu(),
                                   mask.cpu(), kn.cpu(), vn.cpu(),
                                   wpos.cpu(), active.cpu(), softcap=softcap)
        assert _bits_equal(kp.cpu(), plain_k) and _bits_equal(vp.cpu(),
                                                              plain_v)
    else:
        outs = [ops.paged_attention(q, kp, vp, table, mask, softcap=softcap)
                for _ in range(2)]
        clean = ops.paged_attention(q, kpz, vpz, table, mask,
                                    softcap=softcap)
        ref = ops.paged_attention(*args64, softcap=softcap)
        assert _bits_equal(kp, kpn) and _bits_equal(vp, vpn)
    torch.cuda.synchronize()
    assert _rel(outs[0].cpu().double(), ref) <= 1e-5, S
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], clean), S
    assert (outs[0][2] == 0).all(), S


def test_k1_k4_cluster_sizes(cuda):
    """The cases above run every cluster size the planner picks."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sizes = {k1.kv_splits(4, KV, G, hd, T, sms)
             for KV, G, hd, *_ in ATTN_SHAPES[:2]
             for T in (1, 2, 3, 4, 8, 16, 128)}
    assert sizes == {1, 2, 4, 8}


@pytest.mark.parametrize("bs,G,C,hd,softcap,alias",
                         [(16, 4, 16, 256, 0.0, False),
                          (4, 3, 5, 256, 0.0, False),
                          (16, 4, 16, 64, 30.0, False),
                          (8, 2, 7, 64, 0.0, False),
                          (5, 1, 9, 98, 20.0, False),
                          (16, 2, 3, 256, 0.0, False),
                          (32, 1, 2, 256, 0.0, False),
                          (16, 4, 16, 256, 0.0, True),
                          (4, 3, 5, 64, 0.0, True)])
def test_k2_matches_plain(cuda, bs, G, C, hd, softcap, alias):
    """Rows from position 0, one token at a block's last position, a chunk
    ending at the view's end, and a padded row (qpos -1: exact zeros).  The
    blocks past each row's qlast that no row sees hold NaN: the kernel must
    neither load nor compute them (the plain version gets zeros there;
    masked, they add exact zeros).  With `alias` the table draws blocks
    with repeats, so rows (and a row's own positions) share physical
    blocks.  The cases split each row tile's walk over 1, 2, 4 and 8 CTAs;
    two calls are bit-identical (the merge runs in rank order)."""
    g = torch.Generator(device=cuda).manual_seed(bs + G + C + hd + alias)
    B, KV, T = 4, 2, 6
    nb = B * T + 1
    q = torch.randn((B, C, KV * G, hd), generator=g, device=cuda)
    kp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    vp = torch.randn((nb + 1, bs, KV, hd), generator=g, device=cuda)
    if alias:
        table = torch.randint(0, nb, (B, T), generator=g, device=cuda)
    else:
        table = torch.randperm(nb, generator=g, device=cuda)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    start = torch.tensor([0, bs - 1, T * bs - C, 0], device=cuda)
    ntok = torch.tensor([C, 1, C, C], device=cuda)
    j = torch.arange(C, device=cuda)[None, :]
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    qpos[3] = -1
    qlast = qpos.amax(1)
    seen = {int(table[b, t]) for b in range(B) for t in range(T)
            if t * bs <= qlast[b]}
    kpz, vpz = kp.clone(), vp.clone()
    for b in range(B):
        for t in range(T):
            blk = int(table[b, t])
            if t * bs > qlast[b] and blk not in seen:
                kp[blk] = vp[blk] = float("nan")
                kpz[blk] = vpz[blk] = 0.0
    before = k2.paged_prefill.launches
    y = ops.paged_prefill(q, kp, vp, table, qpos, softcap=softcap)
    assert k2.paged_prefill.launches == before + 1
    # the plain version in float64: in float32 on the CPU of the machine
    # that holds the H100, two calls of it differ in some processes by more
    # than the 1e-5 checked here (PERF.md, open questions)
    ref = ops.paged_prefill(q.cpu().double(), kpz.cpu().double(),
                            vpz.cpu().double(), table.cpu(), qpos.cpu(),
                            softcap=softcap)
    assert _rel(y.cpu().double(), ref) <= 1e-5
    assert (y[3] == 0).all()
    assert torch.equal(y, ops.paged_prefill(q, kp, vp, table, qpos,
                                            softcap=softcap))


def test_engine_on_card_launches_every_kernel(cuda):
    _serve_on_card(None)


def test_mixed_engine_on_card_launches_every_kernel(cuda):
    """The mixed placement adds the bit-serial kernel (MLPs on RRAM)."""
    _serve_on_card("mixed")


def test_seamless_engine_on_card_launches_its_kernels(cuda):
    """The enc-dec path: K1 (decoder self-attention), K4 (cross attention)
    and K3; no chunked prefill, so no K2."""
    k2_before = k2.paged_prefill.launches
    _serve_on_card(None, "seamless-m4t-medium")
    assert k2.paged_prefill.launches == k2_before


def _serve_on_card(placement, arch="gemma3-1b"):
    from repro_torch.models import lm
    from repro_torch.serve.engine import GenRequest, ServingEngine
    from repro_torch.serve.spec import build_config
    cfg = build_config(arch, smoke=True, all_global=True, a_per_row=True,
                       placement=placement,
                       model_overrides={"num_layers": 2})
    params = lm.init_model_params(cfg, 0)
    eng = ServingEngine(cfg, params, batch_size=2, max_len=32, paged=True,
                        block_size=8, prefill_chunk=8, fresh_noise=False)
    counters = (k1.paged_attention_decode, k3.emt_matmul)
    counters += ((k4.paged_attention,) if cfg.is_encdec
                 else (k2.paged_prefill,))
    if placement == "mixed":
        counters += (k5.emt_bitserial,)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(0)
    res = eng.serve([GenRequest(prompt=rng.integers(0, 512, n)
                                .astype(np.int32), max_new=4)
                     for n in (5, 12, 9)], stagger=1)
    assert [len(r.tokens) for r in res] == [4, 4, 4]
    assert all(c.launches > b for c, b in zip(counters, before))
    assert eng.energy_conserved(res)
