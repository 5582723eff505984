"""Paged KV cache, host side: block allocator with reservation credits and
per-slot block tables (port of :mod:`repro.serve.kv_pool` without the prefix
registry, ring tables or shards; those come with later slices).

Device side, every attention layer's pool is ``(num_blocks + 1, block_size,
kv_heads, head_dim)``; row ``num_blocks`` is the zero block that unallocated
table entries read.  Admission allocates the prompt's blocks and reserves
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
    """Host-side paged-KV state: one block pool + per-slot block tables.

    ``table[slot, j]`` holds positions ``[j*bs, (j+1)*bs)``; ``-1`` marks an
    unallocated entry, which the device view maps to the zero block."""

    def __init__(self, batch_size: int, max_len: int, block_size: int,
                 num_blocks: int):
        self.batch_size = batch_size
        self.max_len = max_len
        self.block_size = block_size
        self.pool = BlockPool(num_blocks, block_size)
        self.width = self.pool.blocks_for(max_len)
        self.table = np.full((batch_size, self.width), -1, np.int64)

    def needs(self, prompt_len: int, max_new: int):
        """(alloc, reserve) block counts: decode writes positions up to
        prompt_len + max_new - 2, clipped to max_len."""
        total = min(prompt_len + max_new - 1, self.max_len)
        ga = self.pool.blocks_for(prompt_len)
        return ga, self.pool.blocks_for(total) - ga

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether the request could be admitted on an empty pool."""
        return self.pool.num_blocks >= sum(self.needs(prompt_len, max_new))

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return self.pool.can(sum(self.needs(prompt_len, max_new)))

    def admit(self, slot: int, prompt_len: int, max_new: int) -> bool:
        ga, gr = self.needs(prompt_len, max_new)
        ids = self.pool.alloc(slot, ga, reserve=gr)
        if ids is None:
            return False
        self.table[slot, :ga] = ids
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Make position `pos` writable; True if the table changed."""
        j = pos // self.block_size
        if self.table[slot, j] >= 0:
            return False
        self.table[slot, j] = self.pool.append(slot)
        return True

    def release(self, slot: int) -> List[int]:
        ids = self.pool.free(slot)
        self.table[slot] = -1
        return ids

    @property
    def zero_block(self) -> int:
        return self.pool.num_blocks

    def gather_table(self) -> np.ndarray:
        """(B, width) int32 table for reads: unallocated -> zero block."""
        return np.where(self.table >= 0, self.table,
                        self.zero_block).astype(np.int32)

    def scatter_rows(self, slot: int) -> np.ndarray:
        """(width,) int32 row for the prefill insert: unallocated -> out of
        bounds (dropped), so the zero block is never written."""
        return np.where(self.table[slot] >= 0, self.table[slot],
                        self.zero_block + 1).astype(np.int32)
