"""The shared split-K planner (``repro_torch.kernels.splitk``) and the plans
the noisy matmul kernels (K3 ``emt_matmul``, K5 ``emt_bitserial``) and the
chunked prefill kernel (K2 ``paged_prefill``) make from it, on the CPU, at
every main-path shape: gemma3-1b at M = 4 (decode) and 64 (a chunk step),
seamless-m4t-medium at M = 4, 64 and 128 (decode and the legacy prefill
buckets), its ragged 256,206-wide lm_head included.  The shapes come from
the models' own parameter specs; the SM count is the H100's 132."""
import pytest
import torch

from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import emt_matmul as k3
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
    """K5 moved to the shared planner with the rule it had: split until
    two CTAs per SM, at least 256 of K a slab, rounded up to 32-row tiles."""
    p = k5.plan(M, N, K, SMS)
    _check_cover(p)
    tiles = splitk.cdiv(N, 64) * splitk.cdiv(M, 16 if M <= 16 else 64)
    want = max(1, min(2 * SMS // tiles, K // 256))
    k_split = splitk.cdiv(splitk.cdiv(K, want), 32) * 32
    assert (p.k_slab, p.splits) == (k_split, splitk.cdiv(K, k_split))
    _check_workspace(p)


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
