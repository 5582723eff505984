"""Split-K planning shared by the noisy matmul kernels (K3 ``emt_matmul``,
K5 ``emt_bitserial``, and K3's backward through :func:`plan_waves`).

A kernel whose output tiles alone give fewer than ``CTAS_PER_SM`` CTAs per
SM splits K into slabs of whole ``bk``-row tiles, one CTA per (output tile,
slab).  Slab z writes its partial (M, N) sums to slab z of a workspace
(allocated with y by :func:`outputs`) and ``repro::split_sum``
(``csrc/common.cuh``) adds the slabs in slab order into y, so the result is
the same bits on every run.  The C entries check the
plan with ``repro::split_plan_ok``; this module and that check are the two
halves of one contract.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

# The grid a split aims at by default: two CTAs per SM, what K3's and K5's
# register counts (up to 128 a thread, 256 threads a CTA) let an SM hold at
# once.
CTAS_PER_SM = 2
# plan_waves' cost model, in k-tiles of one CTA: the pipeline's fill (two
# tiles in flight before the first product), and the write and read-back
# of one 64 KB partial tile over the card's memory rate (~2.8 k-tiles of
# a 3xTF32 CTA at 132 SMs; estimated from the shapes, and within a few
# percent of the best of 1-128 slabs at gemma3-1b's and the CNN's shapes
# in timed sweeps on an H100 80GB HBM3 at 700 W).
WAVE_FILL = 2
WAVE_IO = 3.0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a (M, K) @ (K, N) product, or ``E`` of them (a stack of
    experts, one grid), is cut: output tiles of bm x bn, K in ``splits``
    slabs of ``k_slab`` rows (whole ``bk``-row tiles)."""
    M: int
    N: int
    K: int
    bm: int
    bn: int
    bk: int
    splits: int
    k_slab: int
    E: int = 1

    @property
    def tiles(self) -> int:
        return cdiv(self.N, self.bn) * cdiv(self.M, self.bm) * self.E

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits


def plan(M: int, N: int, K: int, *, bm: int, bn: int, bk: int, sms: int,
         min_slab: int, max_slab: int = 0, per_sm: int = CTAS_PER_SM,
         experts: int = 1) -> Plan:
    """Split K until the grid holds ``per_sm`` CTAs per SM, with slabs of
    at least ``min_slab`` rows (and, if ``max_slab`` is set, a multiple of
    ``bk``, at most that many), rounded up to whole ``bk`` tiles (so the
    last slab may be shorter and no slab is empty).  A stack of `experts`
    products in one grid counts every expert's tiles; the slabs are each
    expert's own."""
    tiles = cdiv(N, bn) * cdiv(M, bm) * experts
    want = max(1, min(per_sm * sms // tiles, K // min_slab))
    if max_slab:
        want = max(want, cdiv(K, max_slab))
    k_slab = max(bk, cdiv(cdiv(max(K, 1), want), bk) * bk)
    return Plan(M, N, K, bm, bn, bk, max(1, cdiv(K, k_slab)), k_slab,
                experts)


def plan_waves(M: int, N: int, K: int, *, bm: int, bn: int, bk: int,
               sms: int, experts: int = 1) -> Plan:
    """The split of K for a kernel that holds one CTA per SM (K3's
    backward, 225 KB of shared memory a CTA): the slab count s that
    minimizes the modelled time, in units of one bk-deep tile of one CTA,

        ceil(tiles * s / sms) * (ceil(K / bk / s) + WAVE_FILL)
            + WAVE_IO * s * tiles / sms

    that is, the waves of CTAs times each CTA's k-tiles plus its pipeline
    fill, and the partial tiles' write and read-back by the slab sum
    (split_sum, or K3-dw's slab epilogue) spread over the card (none
    without a split).  Ties go to fewer slabs.  Slabs
    are whole bk tiles; the last may be shorter, none is empty.  A stack
    of `experts` products in one grid counts every expert's tiles."""
    tiles = cdiv(N, bn) * cdiv(M, bm) * experts
    kt = max(1, cdiv(K, bk))
    best = None
    for s in range(1, kt + 1):
        per = cdiv(kt, s)
        if cdiv(kt, per) != s:          # the same cut as fewer slabs
            continue
        cost = cdiv(tiles * s, sms) * (per + WAVE_FILL) + (
            WAVE_IO * s * tiles / sms if s > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, s, per = best
    return Plan(M, N, K, bm, bn, bk, s, per * bk, experts)


def outputs(p: Plan, like: torch.Tensor):
    """(y, workspace pointer) for `p` on `like`'s device, one allocation:
    y (E * M, N) (the experts' outputs one after the other), then the
    ``splits`` partial slabs (none without a split: the kernel then writes
    y directly).  y is a view of the whole buffer, so the workspace lives
    as long as y; one allocation costs the host less than two."""
    rows = p.E * p.M
    mn = rows * p.N
    if p.splits == 1:
        y = torch.empty((rows, p.N), dtype=torch.float32, device=like.device)
        return y, y.data_ptr()
    buf = torch.empty((p.splits + 1) * mn, dtype=torch.float32,
                      device=like.device)
    y = buf.as_strided((rows, p.N), (p.N, 1))
    return y, y.data_ptr() + 4 * mn


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
