"""The shared split-K planner (``repro_torch.kernels.splitk``) and the plans
the noisy matmul kernels (K3 ``emt_matmul``, K5 ``emt_bitserial``) and the
chunked prefill kernel (K2 ``paged_prefill``) make from it, the decode
attention kernels' cluster split (K1/K4 ``paged_attention``) and the
two-state integer threshold of the noisy weight, on the CPU, at
every main-path shape: gemma3-1b at M = 4 (decode) and 64 (a chunk step),
seamless-m4t-medium at M = 4, 64 and 128 (decode and the legacy prefill
buckets), its ragged 256,206-wide lm_head included.  The shapes come from
the models' own parameter specs; the SM count is the H100's 132."""
import pytest
import torch

from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels import paged_prefill as k2
from repro_torch.kernels import splitk
from repro_torch.models import lm
from repro_torch.serve.spec import build_config

SMS = 132


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _projections(arch):
    """{(K, N, n_major)} of every projection the analog path runs: the
    stacks' (K, N) weights, and the unembed (the tied table's transpose,
    read k-major in place, or the untied lm_head)."""
    cfg = build_config(arch, "analog", smoke=False, a_per_row=True)
    shapes = {(*v.shape, True) for k, v in _flat(lm.specs(cfg))
              if k.endswith("/w") and len(v.shape) == 2}
    if cfg.tie_embeddings:
        shapes.add((cfg.d_model, cfg.vocab_size, False))
    return sorted(shapes)


GEMMA = _projections("gemma3-1b")
SEAMLESS = _projections("seamless-m4t-medium")
CASES = ([("gemma3-1b", M, s) for M in (4, 64) for s in GEMMA]
         + [("seamless-m4t-medium", M, s) for M in (4, 64, 128)
            for s in SEAMLESS])


def test_main_path_shapes():
    assert (1152, 262144, False) in GEMMA and (6912, 1152, True) in GEMMA
    assert len(GEMMA) == 6
    assert (1024, 256206, True) in SEAMLESS and len(SEAMLESS) == 4


def _slabs(p: splitk.Plan):
    """[(k_begin, k_end)] of every slab, in slab order, as the kernels walk
    them: slab z covers [z * k_slab, min(K, (z + 1) * k_slab))."""
    return [(z * p.k_slab, min(p.K, (z + 1) * p.k_slab))
            for z in range(p.splits)]


def _check_workspace(p: splitk.Plan):
    """splitk.outputs allocates y (M, N) and, past it in the same buffer,
    one (M, N) slab of partials per split; without a split the kernel
    writes y directly and there is no workspace.  (torch.empty: the pages
    are never touched.)"""
    y, part = splitk.outputs(p, torch.empty(0))
    mn = p.M * p.N
    assert y.shape == (p.M, p.N) and y.is_contiguous()
    nbytes = y.untyped_storage().nbytes()
    if p.splits == 1:
        assert part == y.data_ptr() and nbytes == 4 * mn
    else:
        assert part == y.data_ptr() + 4 * mn
        assert nbytes - 4 * mn == 4 * p.splits * mn


def _check_cover(p: splitk.Plan):
    """The K slabs cover [0, K) in order, each a whole number of bk tiles
    except possibly the last, none empty."""
    slabs = _slabs(p)
    assert len(slabs) == p.splits >= 1
    assert p.k_slab % p.bk == 0
    assert slabs[0][0] == 0 and slabs[-1][1] == p.K
    for (a, b), (c, _) in zip(slabs, slabs[1:]):
        assert b == c and b - a == p.k_slab
    assert all(b > a for a, b in slabs)


@pytest.mark.parametrize("arch,M,shape", CASES,
                         ids=[f"{a}-M{M}-{K}x{N}{'' if n else 'T'}"
                              for a, M, (K, N, n) in CASES])
def test_k3_plan(arch, M, shape):
    K, N, n_major = shape
    p = k3.plan(M, N, K, SMS, n_major)
    _check_cover(p)
    gemv = M <= k3.GEMV_MAX_M
    kw = (k3.GEMV_N if n_major else k3.GEMV_K) if gemv else k3.TILED
    assert (p.bn, p.bk) == (kw["bn"], kw["bk"])
    assert p.bm == (M if gemv else k3.TILED["bm"])
    _check_workspace(p)
    # the grid: about two CTAs per SM, or as many slabs as K allows
    target = splitk.CTAS_PER_SM * SMS
    limit = max(1, K // kw["min_slab"])
    if p.tiles >= target:
        assert p.splits == 1
    else:
        want = min(target // p.tiles, limit)
        assert p.ctas <= target and p.splits <= limit
        # as near the target as whole tiles allow: one tile less a slab
        # would need more slabs than that
        assert p.k_slab == p.bk or splitk.cdiv(K, p.k_slab - p.bk) > want
        assert p.ctas >= SMS or p.splits == limit
    if gemv:
        # the x rows of one slab fit the kernel's shared-memory budget
        rows = M if M <= 4 else 8 if M <= 8 else 16
        assert 4 * rows * p.k_slab <= k3.GEMV_X_BYTES


def test_k3_main_path_grids():
    """The decode step's narrow projections (4-18 output stripes of 64
    columns each) fill the card once K is split; the unembed needs no
    split."""
    for K, N in ((1152, 1024), (1024, 1152), (1152, 6912), (6912, 1152)):
        assert k3.plan(4, N, K, SMS, True).ctas >= SMS
    unembed = k3.plan(4, 262144, 1152, SMS, False)
    assert unembed.splits == 1 and unembed.ctas == 8192
    lm_head = k3.plan(4, 256206, 1024, SMS, True)
    assert lm_head.splits == 1 and lm_head.tiles == 2002
    assert k3.plan(64, 1152, 6912, SMS, True).ctas >= SMS


@pytest.mark.parametrize("M", [4, 64])
@pytest.mark.parametrize("K,N", [(1152, 6912), (6912, 1152)])
def test_k5_plan_keeps_its_split_counts(M, K, N):
    """Above 16 rows K5 keeps the tiled kernel's rule: split until two CTAs
    per SM, at least 256 of K a slab, rounded up to 32-row tiles.  At or
    below 16 rows the GEMV kernel's plan takes 128-column tiles (n-major)
    and whole 32-row bands."""
    p = k5.plan(M, N, K, SMS)
    _check_cover(p)
    if M > k5.GEMV_MAX_M:
        tiles = splitk.cdiv(N, 64) * splitk.cdiv(M, 64)
        want = max(1, min(2 * SMS // tiles, K // 256))
        k_split = splitk.cdiv(splitk.cdiv(K, want), 32) * 32
        assert (p.k_slab, p.splits) == (k_split, splitk.cdiv(K, k_split))
    else:
        assert (p.bm, p.bn, p.bk) == (M, 128, 32)
    _check_workspace(p)


# The bit-serial kernel's main-path shapes: the mixed placement's MLPs
# (gemma3-1b wg/wu and wd, n-major) at decode (M 4) and a chunk step (M 64),
# with the 8-bit DAC's 7 planes and the 24-bit DAC's 23 (the smoke's logits
# check); the tests' k-major weights and small row counts.
K5_CASES = ([(M, K, N, True, bits) for M in (4, 64)
             for K, N in ((1152, 6912), (6912, 1152)) for bits in (7, 23)]
            + [(M, 1000, 262, False, 7) for M in (1, 2, 3, 4, 8, 16)]
            + [(16, 777, 514, True, 24), (16, 300, 200, False, 24)])


@pytest.mark.parametrize("M,K,N,n_major,bits", K5_CASES)
def test_k5_gemv_plan(M, K, N, n_major, bits):
    """Slabs cover K in whole 32-row bands; a GEMV slab's staged planes fit
    the kernel's shared memory; the grid holds about as many CTAs as the
    SMs hold at once of the row template, or as many slabs as K allows; a
    repeated call gives the same plan."""
    p = k5.plan(M, N, K, SMS, n_major, bits)
    assert p == k5.plan(M, N, K, SMS, n_major, bits)
    _check_cover(p)
    _check_workspace(p)
    if M > k5.GEMV_MAX_M:
        assert (p.bm, p.bn, p.bk) == (64, 64, 32)
        return
    kw = k5.GEMV_N if n_major else k5.GEMV_K
    assert (p.bm, p.bn, p.bk) == (M, kw["bn"], kw["bk"])
    rows = k5.gemv_rows(M)
    assert 4 * rows * bits * p.k_slab <= k5.GEMV_X_BYTES
    max_slab = k5.GEMV_X_BYTES // (4 * rows * bits) // 32 * 32
    target = k5.GEMV_CTAS_PER_SM[rows] * SMS
    if p.tiles >= target:
        assert p.splits == splitk.cdiv(K, max_slab)
    else:
        # no more CTAs than the target unless the shared memory forces
        # smaller slabs; as near it as whole bands allow: one band less a
        # slab would need more slabs than that
        want = max(1, min(target // p.tiles, K // kw["min_slab"]))
        assert p.ctas <= target or p.splits == splitk.cdiv(K, max_slab)
        assert (p.k_slab == p.bk or splitk.cdiv(K, p.k_slab - p.bk) > want
                or p.splits == splitk.cdiv(K, max_slab))


def test_k5_main_path_grids():
    """The mixed decode step's MLP projections fill the card with five CTAs
    per SM at most (what an SM holds of the M = 4 template): wg/wu (54
    column tiles) in 12 slabs of 96 rows, wd (9 column tiles) in 72 slabs
    of 96."""
    wg = k5.plan(4, 6912, 1152, SMS)
    assert (wg.tiles, wg.splits, wg.k_slab) == (54, 12, 96)
    wd = k5.plan(4, 1152, 6912, SMS)
    assert (wd.tiles, wd.splits, wd.k_slab) == (9, 72, 96)
    for p in (wg, wd):
        assert 4 * SMS <= p.ctas <= 5 * SMS


def test_two_state_int_threshold_matches_the_float_compare():
    """The kernels' two-state lookup compares the hash bits with an integer
    threshold: bits >= t2 iff fl(bits) * 2^-32 >= thr, at the threshold's
    edge and at random bits, for the served corners' tables and others."""
    from repro_torch.core import hashrng
    from repro_torch.core.device import DeviceModel, device_names, get_device
    tables = {DeviceModel().state_probs, (0.3, 0.7), (0.999, 0.001),
              (1e-6, 1 - 1e-6)}
    tables |= {get_device(n).state_probs for n in device_names()
               if get_device(n).num_states == 2}
    gen = torch.Generator().manual_seed(0)
    for probs in tables:
        assert len(probs) == 2
        thr = hashrng.state_thresholds(probs)[0]
        t2 = k3.int_threshold(thr)
        assert k3.noise_params(DeviceModel(state_offsets=(-1.0, 1.0),
                                           state_probs=probs)).t2 == t2
        bits = torch.randint(0, 2 ** 32, (4096,), generator=gen,
                             dtype=torch.int64)
        bits = torch.cat([bits, torch.tensor([0, t2 - 1, t2, t2 + 1,
                                              2 ** 32 - 1])]).clamp(0)
        want = hashrng.bits_to_state(bits, probs) == 1
        assert torch.equal(bits >= t2, want), probs


# The attention kernels' shapes: gemma3-1b decode (K1: KV 1, G 4, hd 256)
# and seamless-m4t-medium's self and cross attention (K1, K4: KV 16, G 1,
# hd 64), batch 4, block 16, at T from 1 to 128 blocks.
ATTN_SHAPES = [(4, 1, 4, 256), (4, 16, 1, 64)]


@pytest.mark.parametrize("B,KV,G,hd", ATTN_SHAPES)
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8, 16, 128])
def test_k1_k4_cluster_plan(B, KV, G, hd, T):
    """Each (row, kv head)'s walk is split over a cluster of a power of two
    CTAs, at most 8 (portable) and one per block, filling the card up to
    WARPS_PER_SM resident warps an SM where the blocks allow; the staged
    chunks and the row's block lists fit the kernel's shared memory; a
    CTA's threads cover the G x hd outputs with at most 8 each; a repeated
    call agrees."""
    S = k1.kv_splits(B, KV, G, hd, T, SMS)
    assert S == k1.kv_splits(B, KV, G, hd, T, SMS)
    assert S & (S - 1) == 0 and 1 <= S <= min(k1.MAX_SPLITS, T)
    nt = k1.threads(G, hd)
    assert nt % 32 == 0 and k1.MIN_THREADS <= nt <= k1.MAX_THREADS
    assert splitk.cdiv(G * hd, nt) <= 8
    warps = B * KV * S * nt // 32
    limit = k1.WARPS_PER_SM * SMS
    assert warps <= limit or S == 1
    assert warps * 2 > limit or S * 2 > min(T, k1.MAX_SPLITS)
    bs = 16
    P = min(bs, 32, 4096 // hd)
    smem = 4 * (3 * ((T + 3) // 4 * 4) + max(4 * P * hd, G * hd))
    assert smem + 4 * (8 * 256 + 8 * 32 + 3 * 8) + 4 * 8 <= 227 * 1024


def test_k1_main_path_grids():
    """gemma3-1b's decode launch (B 4, KV 1, T 8) runs 4 clusters of 8 CTAs
    of 256 threads; seamless-m4t-medium's (KV 16) 64 clusters of 8 CTAs of
    128 threads; at batch 32 the latter's clusters shrink to 1 CTA."""
    assert k1.kv_splits(4, 1, 4, 256, 8, SMS) == 8
    assert k1.threads(4, 256) == 256
    assert k1.kv_splits(4, 16, 1, 64, 8, SMS) == 8
    assert k1.threads(1, 64) == 128
    assert k1.kv_splits(32, 16, 1, 64, 8, SMS) == 1


@pytest.mark.parametrize("K,bk,max_slab", [(1, 32, 0), (31, 32, 0),
                                           (1000, 32, 0), (1000, 128, 256),
                                           (6912, 32, 512), (0, 32, 0)])
def test_splitk_plan_edges(K, bk, max_slab):
    """K below one tile, not a multiple of the tile, capped slabs, and an
    empty K (one split, no slabs to cover)."""
    p = splitk.plan(4, 100, K, bm=4, bn=32, bk=bk, sms=SMS, min_slab=bk,
                    max_slab=max_slab)
    if K == 0:
        assert p.splits == 1
        return
    _check_cover(p)
    if max_slab:
        assert p.k_slab <= max_slab


def test_k2_splits_fill_the_card():
    """The gemma3-1b chunk step (B 4, KV 1, R = 16 x 4, hd 256, 8 blocks of
    16): 64 row tiles, each walk split over a cluster of 4 CTAs; splits are
    powers of two up to 8, at most one per staged chunk."""
    B, KV, R, T, bs, hd = 4, 1, 64, 8, 16, 256
    s = k2.kv_splits(B, KV, R, T, bs, hd, SMS)
    tiles = B * KV * R // k2.ROWS_PER_CTA
    assert s == 4 and tiles * s >= SMS
    for shape in ((4, 2, 2, 6, 32, 256), (4, 2, 15, 6, 4, 256),
                  (4, 2, 9, 6, 5, 98), (1, 1, 1, 64, 16, 64)):
        s = k2.kv_splits(*shape, SMS)
        B, KV, R, T, bs, hd = shape
        assert s & (s - 1) == 0 and 1 <= s <= k2.MAX_SPLITS
        assert s <= splitk.cdiv(T * bs, k2.chunk_positions(hd))
