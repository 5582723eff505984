"""Paged KV cache, host side: refcounted block allocators with reservation
credits, the prefix registry, and per-slot block tables, global and
sliding-window ring (port of :mod:`repro.serve.kv_pool` for one shard).

Device side, every global attention layer's pool is ``(num_blocks + 1,
block_size, kv_heads, head_dim)`` and every ring layer's ``(num_ring_blocks
+ 1, ...)``; the last row is the zero block that unallocated table entries
read.  Admission allocates the prompt's blocks and the ring, and reserves
the decode worst case, so an admitted request never runs out of blocks
mid-decode (``append`` only converts credits).

Prefix caching: every allocated block carries a refcount, and full prompt
blocks can be registered under a rolling hash of the token prefix
(:func:`prefix_key`, byte-identical to the JAX package's keys).  A request
whose prompt starts with a resident registered chain shares those blocks
instead of prefilling them again; a prompt that diverges inside a
registered block reuses its shared head copy-on-write.  A registered block
whose refcount reaches zero parks in a cached-free list, still hit-able,
and is evicted (and zeroed by the engine) only when allocation needs it,
coldest first by a decayed hit count.  Unregistered blocks are blank-freed
as before, so with the prefix cache off the pool behaves as the plain
allocator.  Prefix caching runs on the global pool only: ring K/V is a
positional window of the request's own stream.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


def prefix_key(parent: Optional[bytes], tokens) -> bytes:
    """Rolling hash of one full prompt block, chained through `parent`."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent if parent is not None else b"root")
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def prefix_keys(prompt, block_size: int) -> List[bytes]:
    """Hash chain over the prompt's full blocks (partial tail excluded)."""
    prompt = np.asarray(prompt, np.int32)
    keys, parent = [], None
    for i in range(len(prompt) // block_size):
        parent = prefix_key(parent, prompt[i * block_size:(i + 1) * block_size])
        keys.append(parent)
    return keys


class BlockPool:
    """Fixed-capacity refcounted block allocator with reservation credits.

    ``alloc(owner, n, reserve=r)`` hands out ``n`` ids and earmarks ``r``
    more for later ``append(owner)`` calls, or returns None with no side
    effects.  A block is blank-free (zeroed on device), cached-free
    (refcount 0, registered under a prefix key, evictable) or active
    (refcount >= 1, possibly shared).  Eviction happens inside allocation;
    evicted ids accumulate until :meth:`pop_evicted` so the engine can zero
    them before the new owner writes."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 0 or block_size < 1:
            raise ValueError(f"bad pool ({num_blocks} x {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        self._ref: Dict[int, int] = {}              # active blocks only
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()  # bid -> key
        self._key_to_block: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}      # registered (active+cached)
        self._key_parent: Dict[bytes, Optional[bytes]] = {}
        self._key_tokens: Dict[bytes, np.ndarray] = {}
        self._children: Dict[Optional[bytes], List[bytes]] = {}
        self._evicted: List[int] = []
        # decayed hit count per registered block: eviction takes the
        # coldest cached block (oldest release breaking ties) and decays the
        # survivors, so a hot shared prefix outlives cold one-shot prompts
        self._reuse: Dict[int, float] = {}
        self.reuse_decay = 0.9
        self.hits = 0
        self.evictions = 0

    # -- queries -------------------------------------------------------------
    def blocks_for(self, positions: int) -> int:
        return -(-max(int(positions), 0) // self.block_size)

    @property
    def num_reserved(self) -> int:
        return sum(self._reserved.values())

    @property
    def num_free(self) -> int:
        """Admission headroom: blank and evictable blocks not backing a
        reservation."""
        return len(self._free) + len(self._cached) - self.num_reserved

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_owned(self) -> int:
        return sum(len(ids) for ids in self._owned.values())

    def owned(self, owner: int) -> List[int]:
        return list(self._owned.get(owner, []))

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def can(self, blocks: int) -> bool:
        return self.num_free >= blocks

    # -- prefix registry -----------------------------------------------------
    def lookup(self, key: bytes) -> Optional[int]:
        return self._key_to_block.get(key)

    def key_tokens(self, key: bytes) -> Optional[np.ndarray]:
        return self._key_tokens.get(key)

    def key_of(self, bid: int) -> Optional[bytes]:
        return self._block_key.get(bid)

    def children(self, parent: Optional[bytes]) -> List[bytes]:
        """Keys registered directly under `parent` (partial-tail donors)."""
        return [k for k in self._children.get(parent, ())
                if k in self._key_to_block]

    def register(self, bid: int, key: bytes, parent: Optional[bytes],
                 tokens) -> bool:
        """Register a fully written block under its prefix key.  The first
        registration of a key wins; a block has at most one key."""
        if key in self._key_to_block or bid in self._block_key:
            return False
        if self.refcount(bid) < 1:
            raise RuntimeError(f"registering unallocated block {bid}")
        self._key_to_block[key] = bid
        self._block_key[bid] = key
        self._key_parent[key] = parent
        self._key_tokens[key] = np.ascontiguousarray(tokens, np.int32).copy()
        self._children.setdefault(parent, []).append(key)
        self._reuse[bid] = 0.0
        return True

    def reuse_weight(self, bid: int) -> float:
        """Decayed hit count driving the eviction order."""
        return self._reuse.get(bid, 0.0)

    def _unregister(self, bid: int) -> None:
        self._reuse.pop(bid, None)
        key = self._block_key.pop(bid)
        del self._key_to_block[key]
        parent = self._key_parent.pop(key)
        self._key_tokens.pop(key)
        self._children[parent].remove(key)
        if not self._children[parent]:
            del self._children[parent]

    # -- mutation ------------------------------------------------------------
    def _take_block(self, avoid=()) -> Optional[int]:
        """Pop a blank block; if none, evict the coldest cached-free block
        not in `avoid` and decay the survivors' weights."""
        if self._free:
            return self._free.pop()
        victim = None
        for idx, bid in enumerate(self._cached):    # idx = release order
            if bid in avoid:
                continue
            rank = (self._reuse.get(bid, 0.0), idx)
            if victim is None or rank < victim[0]:
                victim = (rank, bid)
        if victim is None:
            return None
        bid = victim[1]
        del self._cached[bid]
        self._unregister(bid)
        self._evicted.append(bid)
        self.evictions += 1
        for other in self._cached:
            self._reuse[other] *= self.reuse_decay
        return bid

    def pop_evicted(self) -> List[int]:
        """Ids evicted from the registry since the last call: their device
        content is stale and must be zeroed before the new owner's first
        step."""
        out, self._evicted = self._evicted, []
        return out

    def alloc(self, owner: int, blocks: int, reserve: int = 0,
              extend: bool = False, avoid=()) -> Optional[List[int]]:
        """Hand out `blocks` ids (evicting cached blocks, never those in
        `avoid`) and earmark `reserve` more, or return None with no side
        effects.  `extend` adds to an owner that already holds blocks (the
        prefix hits of the same admission)."""
        if not extend and owner in self._owned:
            raise ValueError(f"owner {owner} already holds blocks")
        if self.num_free < blocks + reserve:
            return None
        taken: List[int] = []
        for _ in range(blocks):
            bid = self._take_block(avoid=avoid)
            if bid is None:                         # only avoided evictables
                self._free.extend(taken)
                return None
            taken.append(bid)
        held = self._owned.setdefault(owner, [])
        for bid in taken:
            self._ref[bid] = 1
            held.append(bid)
        if reserve:
            self._reserved[owner] = self._reserved.get(owner, 0) + reserve
        return list(taken)

    def acquire(self, owner: int, bid: int) -> None:
        """Share an existing block with `owner` (a prefix hit): bump its
        refcount, reviving it from the cached-free list if parked there."""
        if bid in self._cached:
            del self._cached[bid]
            self._ref[bid] = 1
        elif self._ref.get(bid, 0) >= 1:
            self._ref[bid] += 1
        else:
            raise RuntimeError(f"block {bid} is blank-free")
        self._owned.setdefault(owner, []).append(bid)
        self.hits += 1
        self._reuse[bid] = self._reuse.get(bid, 0.0) + 1.0

    def append(self, owner: int) -> int:
        """Convert one of `owner`'s reservation credits into a block."""
        if self._reserved.get(owner, 0) <= 0:
            raise RuntimeError(f"owner {owner} has no reserved blocks left")
        self._reserved[owner] -= 1
        bid = self._take_block()         # alloc() kept the credits backed
        if bid is None:
            raise RuntimeError(f"owner {owner}'s reservation is not backed")
        self._ref[bid] = 1
        self._owned[owner].append(bid)
        return bid

    def free(self, owner: int) -> List[int]:
        """Drop `owner`'s references and credits.  Returns only the ids that
        became blank (refcount 0, unregistered): the engine zeroes those.
        A registered block parks in the cached-free list with its content,
        and a shared block only loses one reference."""
        blanks: List[int] = []
        for bid in self._owned.pop(owner, []):
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue
            del self._ref[bid]
            if bid in self._block_key:
                self._cached[bid] = self._block_key[bid]
            else:
                self._free.append(bid)
                blanks.append(bid)
        self._reserved.pop(owner, None)
        return blanks

    def check(self) -> None:
        """Conservation: every block is blank xor cached xor active, exactly
        once; refcounts equal the owners' references; reservations are
        backed; the registry is consistent."""
        active = sorted(self._ref)

        def need(cond, msg):
            if not cond:
                raise AssertionError(msg)

        need(all(self._ref[b] >= 1 for b in active), "zombie refcount")
        need(not (set(active) & set(self._free)), "block both active+free")
        need(not (set(active) & set(self._cached)),
             "block both active+cached")
        need(not (set(self._free) & set(self._cached)), "free+cached overlap")
        need(sorted(active + self._free + list(self._cached))
             == list(range(self.num_blocks)), "block leak/duplication")
        refs: Dict[int, int] = {}
        for ids in self._owned.values():
            for b in ids:
                refs[b] = refs.get(b, 0) + 1
        need(refs == self._ref, "refcount != owner references")
        need(len(self._free) + len(self._cached) >= self.num_reserved,
             "unbacked reservation")
        need(set(self._key_to_block.values()) == set(self._block_key),
             "registry out of sync")
        need(all(b in self._block_key for b in self._cached),
             "cached block without a key")
        need(set(self._reuse) == set(self._block_key),
             "reuse weights out of sync with the registry")


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
        # per-slot prefix bookkeeping: the hash chain of the slot's full
        # written-stream blocks and the tokens behind it (register_filled)
        self._chains: Dict[int, List[bytes]] = {}
        self._chain_tokens: Dict[int, np.ndarray] = {}

    @property
    def prefix_hits(self) -> int:
        return self.pool_g.hits

    @property
    def prefix_evictions(self) -> int:
        return self.pool_g.evictions

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

    def admit_prefix(self, slot: int, prompt, max_new: int) -> Optional[dict]:
        """Admission with prefix-cache reuse (global pool, chunked prefill).

        Walks the prompt's hash chain over resident registered blocks:
        full-block hits are shared (refcount + 1, no prefill); if the prompt
        diverges inside the next registered block, its shared head is
        reused copy-on-write.  At least one prompt position is always left
        to compute: the last prompt token's logits seed sampling.

        Returns None on refusal (pools untouched) or a dict with
        ``cached_len`` (prompt positions served from the cache) and ``cow``
        (``(src, dst)`` block ids to copy on device, or None).  The caller
        zeroes ``pop_evicted_g()`` blocks and does the copy before the
        slot's first step."""
        pool = self.pool_g
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bs = self.block_size
        n = len(prompt)
        keys = prefix_keys(prompt, bs)
        max_cached = n - 1                  # always compute >= 1 token
        hits: List[int] = []
        parent: Optional[bytes] = None
        for i, key in enumerate(keys):
            if (i + 1) * bs > max_cached:
                break
            bid = pool.lookup(key)
            if bid is None or not np.array_equal(
                    pool.key_tokens(key), prompt[i * bs:(i + 1) * bs]):
                break
            hits.append(bid)
            parent = key
        k = len(hits)
        # partial-tail donor: a registered sibling block sharing >= 1
        # leading token of our block-k tail is reused copy-on-write
        cow_src, m = None, 0
        cap = min(max_cached - k * bs, bs, n - k * bs)
        if cap > 0:
            tail = prompt[k * bs:k * bs + cap]
            for ck in pool.children(parent):
                ctoks = pool.key_tokens(ck)
                mm = int(np.argmin(np.concatenate(
                    [ctoks[:len(tail)] == tail, [False]])))
                if mm > m:
                    m, cow_src = mm, pool.lookup(ck)

        ga, gr, _ = self.needs(n, max_new)
        fresh = ga - k
        if not pool.can(fresh + gr):
            return None
        for bid in hits:
            pool.acquire(slot, bid)
        avoid = (cow_src,) if cow_src is not None else ()
        ids = pool.alloc(slot, fresh, reserve=gr, extend=True, avoid=avoid)
        if ids is None and cow_src is not None:
            # the only evictable block was the donor: forgo the COW reuse
            cow_src, m = None, 0
            ids = pool.alloc(slot, fresh, reserve=gr, extend=True)
        if ids is None:
            pool.free(slot)
            return None
        self.table_g[slot, :k] = hits
        self.table_g[slot, k:ga] = ids
        self._chains[slot] = keys
        self._chain_tokens[slot] = prompt
        return {"cached_len": k * bs + m,
                "cow": (cow_src, ids[0]) if cow_src is not None else None}

    def register_filled(self, slot: int, filled: int, stream=None) -> None:
        """Register the slot's fully written blocks (write frontier at
        `filled` positions) so later admissions can share them.

        With `stream=None` this covers the prompt blocks as prefill
        advances (the chain was hashed at admission).  Decode-block
        registration passes the written stream (prompt ++ generated, up to
        the frontier) and extends the chain past the prompt, so an
        identical continuation admits against the decode-written blocks
        too."""
        keys = self._chains.get(slot)
        if keys is None:
            return
        bs = self.block_size
        if stream is not None:
            stream = np.asarray(stream, np.int32).reshape(-1)
            if len(stream) < filled:
                raise ValueError("stream shorter than the write frontier")
            tokens = stream
            self._chain_tokens[slot] = stream
            while (len(keys) + 1) * bs <= len(stream):
                i = len(keys)
                keys.append(prefix_key(keys[-1] if keys else None,
                                       stream[i * bs:(i + 1) * bs]))
        else:
            tokens = self._chain_tokens[slot]
        for i in range(min(filled // bs, len(keys))):
            bid = int(self.table_g[slot, i])
            if self.pool_g.key_of(bid) is not None:
                continue                        # a hit, or registered
            self.pool_g.register(bid, keys[i], keys[i - 1] if i else None,
                                 tokens[i * bs:(i + 1) * bs])

    def ensure(self, slot: int, pos: int) -> bool:
        """Make position `pos` writable; True if the table changed."""
        j = pos // self.block_size
        if self.table_g[slot, j] >= 0:
            return False
        if not (self.table_g[slot, :j] >= 0).all():
            raise RuntimeError(f"slot {slot}: non-contiguous block table")
        self.table_g[slot, j] = self.pool_g.append(slot)
        return True

    def release(self, slot: int) -> Tuple[List[int], List[int]]:
        """Drop `slot`'s block references and clear its table rows.  Returns
        the (global, ring) ids that became blank, which the engine zeroes;
        shared and prefix-cached blocks keep their content."""
        g = self.pool_g.free(slot)
        l = self.pool_l.free(slot) if self.pool_l is not None else []
        self.table_g[slot] = -1
        self.table_l[slot] = -1
        self._chains.pop(slot, None)
        self._chain_tokens.pop(slot, None)
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

    def pop_evicted_g(self) -> List[List[int]]:
        """Global-pool ids evicted since the last call, per shard (one)."""
        return [self.pool_g.pop_evicted()]

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
