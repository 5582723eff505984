"""Split-K planning shared by the noisy matmul kernels (K3 ``emt_matmul``,
K5 ``emt_bitserial``).

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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a (M, K) @ (K, N) product is cut: output tiles of bm x bn, K in
    ``splits`` slabs of ``k_slab`` rows (whole ``bk``-row tiles)."""
    M: int
    N: int
    K: int
    bm: int
    bn: int
    bk: int
    splits: int
    k_slab: int

    @property
    def tiles(self) -> int:
        return cdiv(self.N, self.bn) * cdiv(self.M, self.bm)

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits


def plan(M: int, N: int, K: int, *, bm: int, bn: int, bk: int, sms: int,
         min_slab: int, max_slab: int = 0, per_sm: int = CTAS_PER_SM) -> Plan:
    """Split K until the grid holds ``per_sm`` CTAs per SM, with slabs of
    at least ``min_slab`` rows (and, if ``max_slab`` is set, a multiple of
    ``bk``, at most that many), rounded up to whole ``bk`` tiles (so the
    last slab may be shorter and no slab is empty)."""
    tiles = cdiv(N, bn) * cdiv(M, bm)
    want = max(1, min(per_sm * sms // tiles, K // min_slab))
    if max_slab:
        want = max(want, cdiv(K, max_slab))
    k_slab = max(bk, cdiv(cdiv(max(K, 1), want), bk) * bk)
    return Plan(M, N, K, bm, bn, bk, max(1, cdiv(K, k_slab)), k_slab)


def outputs(p: Plan, like: torch.Tensor):
    """(y, workspace pointer) for `p` on `like`'s device, one allocation:
    y (M, N), then the ``splits`` partial slabs (none without a split: the
    kernel then writes y directly).  y is a view of the whole buffer, so
    the workspace lives as long as y; one allocation costs the host less
    than two."""
    mn = p.M * p.N
    if p.splits == 1:
        y = torch.empty((p.M, p.N), dtype=torch.float32, device=like.device)
        return y, y.data_ptr()
    buf = torch.empty((p.splits + 1) * mn, dtype=torch.float32,
                      device=like.device)
    y = buf.as_strided((p.M, p.N), (p.N, 1))
    return y, y.data_ptr() + 4 * mn


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
