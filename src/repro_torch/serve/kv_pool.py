"""Paged KV cache, host side: block allocators with reservation credits and
per-slot block tables, global and sliding-window ring (port of
:mod:`repro.serve.kv_pool` for one shard, without the prefix registry).

Device side, every global attention layer's pool is ``(num_blocks + 1,
block_size, kv_heads, head_dim)`` and every ring layer's ``(num_ring_blocks
+ 1, ...)``; the last row is the zero block that unallocated table entries
read.  Admission allocates the prompt's blocks and the ring, and reserves
the decode worst case, so an admitted request never runs out of blocks
mid-decode (``append`` only converts credits).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class BlockPool:
    """Fixed-capacity block allocator with reservation credits."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 0 or block_size < 1:
            raise ValueError(f"bad pool ({num_blocks} x {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}

    def blocks_for(self, positions: int) -> int:
        return -(-max(int(positions), 0) // self.block_size)

    @property
    def num_reserved(self) -> int:
        return sum(self._reserved.values())

    @property
    def num_free(self) -> int:
        """Admission headroom: free blocks not backing a reservation."""
        return len(self._free) - self.num_reserved

    def owned(self, owner: int) -> List[int]:
        return list(self._owned.get(owner, []))

    def can(self, blocks: int) -> bool:
        return self.num_free >= blocks

    def alloc(self, owner: int, blocks: int,
              reserve: int = 0) -> Optional[List[int]]:
        """Hand out `blocks` ids and earmark `reserve` more, or return None
        with no side effects."""
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds blocks")
        if self.num_free < blocks + reserve:
            return None
        taken = [self._free.pop() for _ in range(blocks)]
        self._owned[owner] = list(taken)
        if reserve:
            self._reserved[owner] = reserve
        return taken

    def append(self, owner: int) -> int:
        """Convert one of `owner`'s reservation credits into a block."""
        if self._reserved.get(owner, 0) <= 0:
            raise RuntimeError(f"owner {owner} has no reserved blocks left")
        self._reserved[owner] -= 1
        bid = self._free.pop()
        self._owned[owner].append(bid)
        return bid

    def free(self, owner: int) -> List[int]:
        """Release `owner`'s blocks and credits; returns the freed ids (the
        engine zeroes them on device)."""
        ids = self._owned.pop(owner, [])
        self._free.extend(ids)
        self._reserved.pop(owner, None)
        return ids

    def check(self) -> None:
        """Conservation: every block is free xor owned, exactly once, and
        reservations are backed."""
        owned = [b for ids in self._owned.values() for b in ids]
        if sorted(owned + self._free) != list(range(self.num_blocks)):
            raise AssertionError("block leak/duplication")
        if len(self._free) < self.num_reserved:
            raise AssertionError("unbacked reservation")


class PagedKV:
    """Host-side paged-KV state: two block-id spaces and per-slot tables.

    * ``pool_g`` / ``table_g``: global (and cross) attention layers;
      ``table_g[slot, j]`` holds positions ``[j*bs, (j+1)*bs)`` of
      ``[0, max_len)``.
    * ``pool_l`` / ``table_l``: sliding-window ring layers (``ring_len``
      > 0); the ring's ``ring_len`` slots are paged the same way, every
      block allocated at admission (ring writes wrap, so the table never
      grows).  Without a ring, ``pool_l`` is None and ``table_l`` one
      unallocated column.

    ``-1`` marks an unallocated entry; the device views map it to the zero
    block (gathers) or out of bounds (scatters)."""

    def __init__(self, batch_size: int, max_len: int, block_size: int,
                 num_blocks: int, ring_len: int = 0, num_ring_blocks: int = 0):
        self.batch_size = batch_size
        self.max_len = max_len
        self.block_size = block_size
        self.ring_len = ring_len
        self.pool_g = BlockPool(num_blocks, block_size)
        self.pool_l = (BlockPool(num_ring_blocks, block_size) if ring_len
                       else None)
        self.width_g = self.pool_g.blocks_for(max_len)
        self.width_l = self.pool_g.blocks_for(ring_len) if ring_len else 1
        self.table_g = np.full((batch_size, self.width_g), -1, np.int64)
        self.table_l = np.full((batch_size, self.width_l), -1, np.int64)

    def needs(self, prompt_len: int, max_new: int):
        """(global alloc, global reserve, ring alloc) block counts: decode
        writes positions up to prompt_len + max_new - 2, clipped to
        max_len; the ring takes its whole window at admission."""
        total = min(prompt_len + max_new - 1, self.max_len)
        ga = self.pool_g.blocks_for(prompt_len)
        gr = self.pool_g.blocks_for(total) - ga
        la = self.pool_l.blocks_for(self.ring_len) if self.pool_l else 0
        return ga, gr, la

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether the request could be admitted on empty pools."""
        ga, gr, la = self.needs(prompt_len, max_new)
        return (self.pool_g.num_blocks >= ga + gr
                and (self.pool_l is None or self.pool_l.num_blocks >= la))

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        ga, gr, la = self.needs(prompt_len, max_new)
        return (self.pool_g.can(ga + gr)
                and (self.pool_l is None or self.pool_l.can(la)))

    def admit(self, slot: int, prompt_len: int, max_new: int) -> bool:
        """Allocate the prompt's blocks, the decode reservation and the
        ring; all or nothing."""
        ga, gr, la = self.needs(prompt_len, max_new)
        ids_g = self.pool_g.alloc(slot, ga, reserve=gr)
        if ids_g is None:
            return False
        if self.pool_l is not None:
            ids_l = self.pool_l.alloc(slot, la)
            if ids_l is None:
                self.pool_g.free(slot)
                return False
            self.table_l[slot, :la] = ids_l
        self.table_g[slot, :ga] = ids_g
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Make position `pos` writable; True if the table changed."""
        j = pos // self.block_size
        if self.table_g[slot, j] >= 0:
            return False
        self.table_g[slot, j] = self.pool_g.append(slot)
        return True

    def release(self, slot: int):
        """Free `slot`'s blocks; returns the (global, ring) ids, which the
        engine zeroes."""
        g = self.pool_g.free(slot)
        l = self.pool_l.free(slot) if self.pool_l is not None else []
        self.table_g[slot] = -1
        self.table_l[slot] = -1
        return g, l

    @property
    def zero_block_g(self) -> int:
        return self.pool_g.num_blocks

    @property
    def zero_block_l(self) -> int:
        return self.pool_l.num_blocks if self.pool_l is not None else 0

    def gather_tables(self):
        """(B, width_g), (B, width_l) int32 tables for reads: unallocated
        -> the zero block."""
        tg = np.where(self.table_g >= 0, self.table_g, self.zero_block_g)
        tl = np.where(self.table_l >= 0, self.table_l, self.zero_block_l)
        return tg.astype(np.int32), tl.astype(np.int32)

    def scatter_rows(self, slot: int):
        """(width_g,), (width_l,) int32 rows for the prefill insert:
        unallocated -> out of bounds (dropped), so the zero block is never
        written."""
        rg = np.where(self.table_g[slot] >= 0, self.table_g[slot],
                      self.zero_block_g + 1)
        rl = np.where(self.table_l[slot] >= 0, self.table_l[slot],
                      self.zero_block_l + 1)
        return rg.astype(np.int32), rl.astype(np.int32)

    def check(self) -> None:
        """Both pools' conservation, and every table entry owned by its
        slot."""
        for pool, table in ((self.pool_g, self.table_g),
                            (self.pool_l, self.table_l)):
            if pool is None:
                continue
            pool.check()
            for slot in range(self.batch_size):
                ids = [int(b) for b in table[slot] if b >= 0]
                if not set(ids) <= set(pool.owned(slot)):
                    raise AssertionError(f"slot {slot} table names blocks "
                                         f"it does not own")
