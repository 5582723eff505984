"""The shared split-K planner (``repro_torch.kernels.splitk``) and the plans
the noisy matmul kernels (K3 ``emt_matmul``, K5 ``emt_bitserial``) and the
chunked prefill kernel (K2 ``paged_prefill``) make from it, the decode
attention kernels' cluster split (K1/K4 ``paged_attention``) and the
two-state integer threshold of the noisy weight, and the three-piece TF32
split of K3's tensor-core forward, on the CPU, at every main-path shape:
gemma3-1b at M = 4 (decode), 20 (a verify step), 64 (a chunk step) and
1,024 (a training step), seamless-m4t-medium at M = 4, 20, 64, 128 (decode
and the legacy prefill buckets) and 1,024, its ragged 256,206-wide lm_head
included, and vgg16_cifar's convolutions and head.  The shapes come from
the models' own parameter specs; the SM count is the H100's 132."""
import numpy as np
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
CASES = ([("gemma3-1b", M, s) for M in (4, 20, 64, 1024) for s in GEMMA]
         + [("seamless-m4t-medium", M, s) for M in (4, 20, 64, 128, 1024)
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


def _check_waves(p: splitk.Plan):
    """A one-CTA-per-SM plan (splitk.plan_waves, 128 x 128 tiles): the
    grid fills at least one wave of the SMs, or holds as many CTAs as fit
    in one wave whole slabs allow (the next finer cut would pass it, or
    there is none); the slab count is the argmin of the cost model."""
    assert (p.bm, p.bn, p.bk) == (128, 128, 32)
    assert p.tiles == splitk.cdiv(p.M, 128) * splitk.cdiv(p.N, 128)
    finer = _next_cut(p)
    assert p.ctas >= SMS or finer is None or p.tiles * finer > SMS
    kt = splitk.cdiv(p.K, 32)

    def cost(s):
        per = splitk.cdiv(kt, s)
        return (splitk.cdiv(p.tiles * s, SMS) * (per + splitk.WAVE_FILL)
                + (splitk.WAVE_IO * s * p.tiles / SMS if s > 1 else 0.0))
    assert all(cost(p.splits) <= cost(s) for s in range(1, kt + 1))


@pytest.mark.parametrize("arch,M,shape", CASES,
                         ids=[f"{a}-M{M}-{K}x{N}{'' if n else 'T'}"
                              for a, M, (K, N, n) in CASES])
def test_k3_plan(arch, M, shape):
    """At M <= 16 the GEMV's cut (about two CTAs per SM, whole chunks, the
    staged x rows within budget); above, the tensor-core forward's: whole
    32-row k-steps, the cost model's argmin, a wave of the SMs where whole
    slabs allow.  Either way the slabs cover K and the workspace has one
    (M, N) slab per split."""
    K, N, n_major = shape
    p = k3.plan(M, N, K, SMS, n_major)
    assert p == k3.plan(M, N, K, SMS, n_major)
    _check_cover(p)
    _check_workspace(p)
    if M > k3.GEMV_MAX_M:
        assert (p.bm, p.bn, p.bk) == (k3.TC["bm"], k3.TC["bn"], k3.TC["bk"])
        _check_waves(p)
        return
    kw = k3.GEMV_N if n_major else k3.GEMV_K
    assert (p.bn, p.bk) == (kw["bn"], kw["bk"])
    assert p.bm == M
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
    # the x rows of one slab fit the kernel's shared-memory budget
    rows = M if M <= 4 else 8 if M <= 8 else 16
    assert 4 * rows * p.k_slab <= k3.GEMV_X_BYTES


def test_k3_main_path_grids():
    """The decode step's narrow projections (4-18 output stripes of 64
    columns each) fill the card once K is split; the unembed needs no
    split.  At a chunk step the tensor-core forward cuts the down
    projection's K (9 output tiles) into 14 slabs of 512 rows (126 CTAs:
    15 would pass one wave), and at a training step into 7 (504 CTAs);
    the unembed's 2,048 and 16,384 tiles need no split.  Above 16 rows the
    experts entry takes its tensor-core kernel's cut (256 columns by a
    64-row tile at 20 rows, one CTA an SM), a single product K3's."""
    for K, N in ((1152, 1024), (1024, 1152), (1152, 6912), (6912, 1152)):
        assert k3.plan(4, N, K, SMS, True).ctas >= SMS
    unembed = k3.plan(4, 262144, 1152, SMS, False)
    assert unembed.splits == 1 and unembed.ctas == 8192
    lm_head = k3.plan(4, 256206, 1024, SMS, True)
    assert lm_head.splits == 1 and lm_head.tiles == 2002
    down = k3.plan(64, 1152, 6912, SMS, True)
    assert (down.tiles, down.splits, down.k_slab) == (9, 14, 512)
    assert k3.plan(1024, 1152, 6912, SMS, True).ctas == 504
    assert k3.plan(64, 262144, 1152, SMS, False).ctas == 2048
    assert k3.plan(1024, 262144, 1152, SMS, False).ctas == 16384
    chunk = k3.plan(20, 2048, 1408, SMS, True, experts=64)
    assert (chunk.bm, chunk.bn, chunk.E) == (64, 256, 64)
    assert chunk == splitk.plan_waves(20, 2048, 1408, sms=SMS, bm=64,
                                      bn=256, bk=32, experts=64)
    # one product above 16 rows: K3's tensor-core plan
    assert k3.plan(20, 2048, 1408, SMS, True) == splitk.plan_waves(
        20, 2048, 1408, sms=SMS, **k3.TC)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "experts"])
def test_gemv_ring_geometry(int8):
    """The int8 and experts GEMVs' ring as csrc/emt_matmul.cu sizes it: a
    stage is the 8 warps' 4 int8 or 2 float32 rows of 128 columns, at
    least three stages, the end-of-slab reduction's 8 x 4 x 128 floats fit
    in it, the planner's 32-row chunks hold whole stages, and two CTAs
    keep 24-32 KB in flight on an SM."""
    r = k3.GEMV_RING[int8]
    assert r["rows"] == 8 * (4 if int8 else 2)
    assert r["stage_bytes"] == r["rows"] * 128 * (1 if int8 else 4)
    assert r["stages"] >= 3
    assert r["stages"] * r["stage_bytes"] >= 8 * 4 * 128 * 4
    assert k3.GEMV_N["bk"] % r["rows"] == 0
    in_flight = splitk.CTAS_PER_SM * (r["stages"] - 1) * r["stage_bytes"]
    assert 24 * 1024 <= in_flight <= 32 * 1024


@pytest.mark.parametrize("M", [17, 20, 24, 33, 40, 48, 64, 65, 128, 130])
def test_experts_tc_geometry(M):
    """The experts' tensor-core kernel above 16 rows as
    csrc/emt_experts_tc.cu sizes it: a row tile is M rounded up to a
    multiple of 8 (wgmma's N: 24, 32, 48 or 64 rows), two 64-row tiles a
    CTA above 64 rows and later row tiles in the grid above 128; 256
    weight columns a CTA up to 32 rows, 128 above; one CTA's shared memory
    within what an SM gives it; the statistics slots the C entry counts
    from its grid equal the plan's CTAs; jamba's stacks (16 experts of
    4,096 x 14,336 and back) fill the card unsplit."""
    rows = k3.experts_tile_rows(M)
    assert rows in (24, 32, 48, 64) and rows >= min(M, 64)
    assert rows - min(M, 64) < 16
    assert k3.experts_tc_rows(M) == (64 if M <= 64 else 128)
    cols = k3.experts_tc_cols(M)
    assert cols == (256 if M <= 32 else 128)
    assert k3.experts_tc_smem(M) + k3.RESERVED_SMEM <= k3.SMEM_PER_SM
    for E, K, N in ((16, 4096, 14336), (16, 14336, 4096), (3, 100, 130),
                    (1, 777, 514)):
        p = k3.plan(M, N, K, SMS, True, experts=E)
        gx, gy, gz = k3.experts_grid(p)
        assert gx * gy * gz == p.ctas
        assert (gx, gy) == (splitk.cdiv(N, cols),
                            splitk.cdiv(M, k3.experts_tc_rows(M)))
        assert (p.bn, p.bk, p.E) == (cols, 32, E) and p.k_slab % 32 == 0
        assert p.splits * p.k_slab >= K > (p.splits - 1) * p.k_slab
        if E == 16:
            assert p.splits == 1 and p.ctas >= SMS


# the ring's main-path calls (kind, E, M, K, N): gemma3-1b's n-major
# projections as int8 levels at a decode step, moonshot-v1-16b-a3b's
# expert stacks at a decode step's and a chunk step's rows
RING_PATH = ([("int8", 1, 4, K, N) for K, N, n in GEMMA if n]
             + [("experts", 64, M, K, N) for M in (4, 8)
                for K, N in ((2048, 1408), (1408, 2048))])


@pytest.mark.parametrize("kind,E,M,K,N", RING_PATH)
def test_gemv_ring_plan(kind, E, M, K, N):
    """At the ring's path shapes the float weight's cut (the int8 entry
    plans as the float one, the experts' GEMV as a one-expert stack)
    gives slabs of whole ring stages, and two CTAs' rings, x rows and
    statistics fit the shared memory an SM gives its CTAs."""
    int8 = kind == "int8"
    p = k3.plan(M, N, K, SMS, True, experts=E)
    assert (p.bn, p.bk, p.E) == (128, 32, E)
    assert p.k_slab % k3.GEMV_RING[int8]["rows"] == 0
    assert (splitk.CTAS_PER_SM * (k3.gemv_ring_smem(M, p.k_slab, int8)
                                  + k3.RESERVED_SMEM) <= k3.SMEM_PER_SM)
    one = k3.plan(M, N, K, SMS, True, experts=1)
    assert (one.k_slab, one.bk) == (k3.plan(M, N, K, SMS, True).k_slab, 32)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 16])
def test_gemv_ring_fits_at_every_row_template(M):
    """The largest slab the planner gives a row template (x rows within
    GEMV_X_BYTES) still fits two CTAs of either ring on an SM."""
    rows = M if M <= 4 else 8 if M <= 8 else 16
    k_slab = k3.GEMV_X_BYTES // (4 * rows) // 32 * 32
    p = k3.plan(M, 128, 100 * k_slab, 1, True)
    assert p.k_slab == k_slab
    for int8 in (True, False):
        assert (splitk.CTAS_PER_SM * (k3.gemv_ring_smem(M, k_slab, int8)
                                      + k3.RESERVED_SMEM) <= k3.SMEM_PER_SM)


@pytest.mark.parametrize("M", [4, 64])
@pytest.mark.parametrize("K,N", [(1152, 6912), (6912, 1152)])
def test_k5_plan_keeps_its_split_counts(M, K, N):
    """Above 16 rows K5's tensor-core kernel (one CTA an SM, 128 weight
    columns by 64 rows) takes plan_waves' slab count: at a chunk step wg/wu
    (54 tiles) in 2 slabs of 576 rows, wd (9 tiles) in 14 of 512.  At or
    below 16 rows the GEMV kernel's plan takes 128-column tiles (n-major)
    and whole 32-row bands."""
    p = k5.plan(M, N, K, SMS)
    _check_cover(p)
    if M > k5.GEMV_MAX_M:
        assert p == splitk.plan_waves(M, N, K, sms=SMS, bm=64, bn=128, bk=32)
        assert (p.tiles, p.splits, p.k_slab) == (
            (54, 2, 576) if N == 6912 else (9, 14, 512))
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
        assert (p.bm, p.bn, p.bk) == (64 if M <= 64 else 128, 128, 32)
        assert p == splitk.plan_waves(M, N, K, sms=SMS, bm=k5.tc_rows(M),
                                      **k5.TC)
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


def test_folded_hash_matches_hash_counters():
    """The GEMV ring's hash (csrc/common.cuh hash_mix_folded, modelled
    step by step): the column term pre-shifted once per thread, the row
    term with the seed and plane once per row, one XOR an element, and
    the xorshift pair between the two finalize rounds folded into one
    constant; the bits of hashrng.hash_counters at random counters and
    at the edges of uint32."""
    from repro_torch.core import hashrng
    mul = hashrng._mul
    gen = torch.Generator().manual_seed(0)
    edge = torch.tensor([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31, 2 ** 32 - 1])
    row = torch.cat([torch.randint(0, 2 ** 32, (20000,), generator=gen,
                                   dtype=torch.int64), edge.repeat(6)])
    col = torch.cat([torch.randint(0, 2 ** 32, (20000,), generator=gen,
                                   dtype=torch.int64),
                     edge.repeat_interleave(6)])

    def pre(t):
        return t ^ (t >> 16)

    for seed, plane in ((0, 0), (99, 1234), (2 ** 32 - 1, 7)):
        pks = pre(mul(torch.tensor(plane), 0xC2B2AE35) ^ seed)
        x = pre(mul(col, 0x85EBCA6B)) ^ pre(mul(row, 0x9E3779B9)) ^ pks
        x = mul(x, 0x7FEB352D)
        x = x ^ (x >> 15)
        x = mul(x, 0x846CA68B)
        x = x ^ (0x68E31DA4 ^ (0x68E31DA4 >> 16))
        x = mul(x, 0x7FEB352D)
        x = x ^ (x >> 15)
        x = mul(x, 0x846CA68B)
        x = x ^ (x >> 16)
        assert torch.equal(x, hashrng.hash_counters(seed, row, col, plane))


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


def _cnn_shapes():
    """{(M, K, N)} of vgg16_cifar's K3 calls at batch 32: each conv's
    im2col rows (32 images x its stage's H x W), 9 x C_in and C_out, and
    the head."""
    from repro_torch.configs import paper_cnn
    cfg = paper_cnn.vgg16_cifar()
    shapes, cin, side = set(), cfg.in_channels, cfg.image_size
    for c in cfg.channels:
        for b in range(cfg.blocks_per_stage):
            shapes.add((32 * side * side, 9 * (cin if b == 0 else c), c))
            shapes.add((32 * side * side, 9 * c, c))
        cin, side = c, side // 2
    shapes.add((32, cfg.channels[-1], cfg.num_classes))
    return sorted(shapes)


CNN = _cnn_shapes()


# K5's tensor-core kernel at its main-path shapes: the mixed chunk step's
# MLPs (M = 64) and vgg16_cifar's 13 calls a step (its convolutions' im2col
# rows and the head), in both weight layouts and at the 8-bit and 24-bit
# DACs' 7 and 23 planes.
K5_TC_CASES = [(M, K, N, n, bits)
               for M, K, N in [(64, 1152, 6912), (64, 6912, 1152)] + CNN
               for n in (True, False) for bits in (7, 23)]


@pytest.mark.parametrize("M,K,N,n_major,bits", K5_TC_CASES)
def test_k5_tensor_core_plan(M, K, N, n_major, bits):
    """Above 16 rows: slabs of whole 32-row k-tiles covering K with none
    empty (the C entry's split_plan_ok), the plan_waves argmin, whatever
    the layout or the planes, filling a wave of the SMs where whole
    k-tiles allow; a CTA's rows one 64-row tile up to 64 rows, two above
    (the kernel's shared memory is checked by a static_assert in its
    source)."""
    p = k5.plan(M, N, K, SMS, n_major, bits)
    assert (p.bm, p.bn, p.bk) == (64 if M <= 64 else 128, 128, 32)
    assert p.k_slab % 32 == 0 and p.splits * p.k_slab >= K
    assert (p.splits - 1) * p.k_slab < K
    _check_cover(p)
    _check_workspace(p)
    assert p == splitk.plan_waves(M, N, K, sms=SMS, bm=p.bm, bn=128, bk=32)
    # the wave condition: at least one wave of the SMs, or the finest cut
    # whole k-tiles allow that stays within one
    finer = _next_cut(p)
    assert p.ctas >= SMS or finer is None or p.tiles * finer > SMS
# K3's backward at every main-path shape: (M, K, N) with M the rows of x
# and g, w (K, N); gemma3-1b's six at a training step's M = 8 x 128 (the
# unembed is table.T), and the CNN's
K3_BWD_SHAPES = ([(1024, K, N) for K, N, _ in GEMMA] + CNN)


# K3's forward on the tensor cores at every main-path weight of the three
# models, at a verify step's M = 20, a chunk step's 64, a training step's
# 1,024 and the CNN's first stage's 32,768 rows (each projection's layout:
# the tied unembed k-major)
K3_FWD_CASES = [(M, K, N, n) for M in (20, 64, 1024, 32768)
                for K, N, n in GEMMA + SEAMLESS + [(K, N, True)
                                                   for _, K, N in CNN]]


@pytest.mark.parametrize("M,K,N,n_major", K3_FWD_CASES,
                         ids=[f"M{M}-{K}x{N}{'' if n else 'T'}"
                              for M, K, N, n in K3_FWD_CASES])
def test_k3_forward_plan(M, K, N, n_major):
    """The tensor-core forward's cut of (M, K) @ (K, N): plan_waves over
    (M, N) outputs and K, slabs covering K in whole k-steps, the wave and
    argmin conditions, one workspace slab per split; the two-state noise
    bits only where x has more than one 128-row tile (N rows of
    ceil(K / 32) words)."""
    p = k3.plan(M, N, K, SMS, n_major)
    assert p == splitk.plan_waves(M, N, K, sms=SMS, **k3.TC)
    assert (p.M, p.N, p.K) == (M, N, K)
    _check_cover(p)
    _check_waves(p)
    _check_workspace(p)
    words = k3.tc_bits_words(M, N, K)
    assert words == (N * splitk.cdiv(K, 32) if M > 128 else 0)


def test_k3_backward_main_path_shapes():
    assert (32768, 27, 64) in CNN and (32768, 576, 64) in CNN
    assert (2048, 2304, 256) in CNN and len(CNN) == 7
    assert (1024, 1152, 262144) in K3_BWD_SHAPES


def _next_cut(p: splitk.Plan):
    """The slab count of the next finer cut of p's reduction into whole
    bk tiles (more slabs than p's), None when p's slabs are one tile."""
    kt = splitk.cdiv(max(p.K, 1), p.bk)
    per = p.k_slab // p.bk
    return splitk.cdiv(kt, per - 1) if per > 1 else None


@pytest.mark.parametrize("which", ["dx", "dw"])
@pytest.mark.parametrize("M,K,N", K3_BWD_SHAPES,
                         ids=[f"M{M}-{K}x{N}" for M, K, N in K3_BWD_SHAPES])
def test_k3_backward_plan(which, M, K, N):
    """K3-dx's and K3-dw's cut (128 x 128 output tiles, one CTA per SM):
    slabs of whole 32-deep k-steps covering the reduction (dx: N, dw: M);
    the grid fills at least one wave of 132 SMs, or holds as many CTAs
    as fit in one wave whole slabs allow (the next finer cut would pass
    it, or there is none); the plan is the argmin of plan_waves' cost
    model; the buffers have the sizes the C entries read; dw's partials of
    dsigma are four per output tile (its 32-row quarters), whatever the SM
    count."""
    plan = k3.plan_dx if which == "dx" else k3.plan_dw
    p = plan(M, K, N, SMS)
    assert p == plan(M, K, N, SMS)
    _check_cover(p)
    out, red = ((M, K), N) if which == "dx" else ((K, N), M)
    assert (p.M, p.N, p.K) == (*out, red)
    _check_waves(p)
    if which == "dx":
        _check_workspace(p)
        return
    ws, part = k3.dw_buffer_floats(p)
    assert ws == (p.splits * K * N if p.splits > 1 else 0)
    for sms in (78, 114, 132, 144):
        q = k3.plan_dw(M, K, N, sms)
        assert k3.dw_buffer_floats(q)[1] == part == 4 * p.tiles + 1


def test_k3_backward_main_path_grids():
    """The thin gemma3-1b outputs split their reduction: dx of the
    (1152, 6912) and unembed weights (72 tiles of (1024, 1152)) into 7 and
    11 slabs; dw of the CNN's first conv (one (27, 64) tile over M =
    32,768) into 128 slabs of 256 rows; the wide ones do not."""
    assert k3.plan_dx(1024, 1152, 6912, SMS).splits == 7
    assert k3.plan_dx(1024, 1152, 262144, SMS).splits == 11
    first = k3.plan_dw(32768, 27, 64, SMS)
    assert (first.tiles, first.splits, first.k_slab) == (1, 128, 256)
    assert k3.plan_dw(1024, 1152, 262144, SMS).splits == 1
    assert k3.plan_dx(1024, 6912, 1152, SMS).splits == 1


def _split3(w: np.ndarray):
    """K3's tensor-core forward's split of its weight operand
    (csrc/emt_tc.cuh split<3>), mirrored in numpy's float32: hi = w with
    the low 13 significand bits cleared, mid the same of r = w - hi, lo =
    r - mid (float32 subtractions, rounded to nearest)."""
    mask = np.uint32(0xFFFFE000)
    hi = (w.view(np.uint32) & mask).view(np.float32)
    r = w - hi
    mid = (r.view(np.uint32) & mask).view(np.float32)
    return hi, mid, r - mid


def _significant_bits(v: np.ndarray) -> np.ndarray:
    """The significant bits of each float32 value (0 for zeros): the span
    of its significand from the leading to the last set bit."""
    mant, _ = np.frexp(np.abs(v.astype(np.float64)))
    ints = np.round(mant * 2.0 ** 24).astype(np.int64)
    bits = np.zeros(v.shape, dtype=np.int64)
    nz = ints != 0
    low = ints[nz] & -ints[nz]
    bits[nz] = 24 - np.round(np.log2(low)).astype(np.int64)
    return bits


def test_tf32_three_piece_split_is_exact():
    """On ~10^5 random float32 values over the whole range and the edge
    cases (+-0, subnormals, powers of two, FLT_MAX, values rna would round
    up to the next power of two): hi + mid + lo == w bit for bit in any
    order (-0 gives +0); every partial sum is exact (equal to its float64
    sum) and no larger in magnitude than w; the pieces have w's sign.
    Where all three pieces are normal (|w| >= 2^-103), hi and mid have at
    most 11 significant bits and lo at most 2, so each is a TF32 value
    (its low 13 significand bits clear) and x_hi * (hi + mid + lo) is
    exact in TF32 products; a subnormal keeps its low 13 bits whole in lo
    (TF32 holds nothing below 2^-136), far below any weight the kernels
    see."""
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    f32 = np.finfo(np.float32)
    powers = np.ldexp(np.float32(1), np.arange(-149, 128)).astype(np.float32)
    below = np.nextafter(powers[1:], np.float32(0))      # rna rounds up
    edges = np.array([0.0, -0.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
                      f32.smallest_subnormal, 1.0 - 2.0 ** -24,
                      2.0 - 2.0 ** -23, 1.0 + 2.0 ** -23 + 2.0 ** -22],
                     dtype=np.float32)
    subnormal = np.arange(1, 2 ** 13, 37, dtype=np.uint32).view(np.float32)
    w = np.concatenate([rand, powers, -powers, below, -below, edges,
                        subnormal, -subnormal])
    w = w[np.isfinite(w)]
    hi, mid, lo = _split3(w)
    bits = w.view(np.uint32)
    pieces = (hi, mid, lo)
    import itertools
    # bit for bit, but for w = -0, whose pieces -0, +0, +0 add to +0 (the
    # kernels' sums start from +0 anyway: their -0 weights give +0, as
    # the FP32 kernel's did)
    nz = w != 0
    for a, b, c in itertools.permutations(pieces):
        total = (a + b) + c
        assert np.array_equal(total[nz].view(np.uint32), bits[nz])
        assert (total[~nz] == 0).all()
    exact = w.astype(np.float64)
    for i, j in itertools.combinations(range(3), 2):
        part = pieces[i] + pieces[j]
        assert np.array_equal(part.astype(np.float64),
                              pieces[i].astype(np.float64)
                              + pieces[j].astype(np.float64))
        assert (np.abs(part) <= np.abs(w)).all()
    assert np.array_equal(sum(p.astype(np.float64) for p in pieces), exact)
    for p in pieces:
        assert (np.abs(p) <= np.abs(w)).all()
        assert ((p == 0) | (np.signbit(p) == np.signbit(w))).all()
    normal = np.abs(w) >= 2.0 ** -103
    assert normal.sum() > 90_000
    assert (_significant_bits(hi[normal]) <= 11).all()
    assert (_significant_bits(mid[normal]) <= 11).all()
    assert (_significant_bits(lo[normal]) <= 2).all()
    for p in pieces:
        nz = normal & (p != 0)
        low = p[nz].view(np.uint32) & np.uint32(0x1FFF)
        # the normal pieces' significands fit TF32's 10 stored bits
        assert (low == 0).all()
    tiny = np.abs(w) < f32.tiny
    assert np.array_equal(lo[tiny].view(np.uint32) & np.uint32(0x7FFFFFFF),
                          bits[tiny] & np.uint32(0x1FFF))
