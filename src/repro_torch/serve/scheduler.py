"""FIFO slot scheduler for the continuous-batching engine (host side,
port of :mod:`repro.serve.scheduler` for one shard)."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

from repro_torch.serve.kv_pool import PagedKV


class RejectedError(RuntimeError):
    """Admission refused under backpressure: the bounded queue is full."""


@dataclasses.dataclass
class Slot:
    """One in-flight request bound to a batch row."""
    rid: int
    req: object
    pos: int                        # next cache write index (absolute)
    last_token: int
    generated: List[int] = dataclasses.field(default_factory=list)
    energy_pj: float = 0.0          # decode-energy share so far
    prefill_energy_pj: float = 0.0
    steps: int = 0
    enc_len: int = 0                # real encoder positions cached (enc-dec)
    # the prompt still streaming in (chunked prefill); None = legacy
    # bucketed prefill (the slot is placed ready to decode)
    prompt: object = None
    # speculative decoding (serve/speculative.py; zero on plain engines):
    # the subset of energy_pj / prefill_energy_pj billed on the draft
    # placement, and the request's draft proposals and acceptances
    draft_energy_pj: float = 0.0
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def prefilling(self) -> bool:
        return self.prompt is not None and self.pos < len(self.prompt)

    @property
    def sample_pos(self) -> int:
        return len(self.generated)


class Scheduler:
    """FIFO admission queue + slot table, and the paged-KV block tables
    when the engine pages its cache (`kv`; None on the contiguous cache,
    where a free slot is the whole budget)."""

    def __init__(self, batch_size: int, kv: Optional[PagedKV] = None,
                 max_pending: Optional[int] = None):
        self.batch_size = batch_size
        self.kv = kv
        self.max_pending = max_pending
        self.queue: deque = deque()
        self.slots: List[Optional[Slot]] = [None] * batch_size
        self._next_rid = 0

    def submit(self, req) -> int:
        if self.max_pending is not None and len(self.queue) >= self.max_pending:
            raise RejectedError(
                f"pending queue full ({len(self.queue)} >= "
                f"max_pending={self.max_pending}): shed load or retry")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append((rid, req))
        return rid

    @property
    def pending(self) -> int:
        return len(self.queue)

    def peek_pending(self):
        return self.queue[0]

    def pop_pending(self):
        return self.queue.popleft()

    def remove_pending(self, rid: int):
        for i, (qrid, req) in enumerate(self.queue):
            if qrid == rid:
                del self.queue[i]
                return req
        return None

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """A free slot, and the global and ring block budgets (paged)."""
        return (self.free_slot() is not None
                and (self.kv is None
                     or self.kv.can_admit(prompt_len, max_new)))

    def place(self, slot_id: int, slot: Slot) -> None:
        if self.slots[slot_id] is not None:
            raise RuntimeError(f"slot {slot_id} occupied")
        self.slots[slot_id] = slot

    def retire(self, slot_id: int) -> Slot:
        slot = self.slots[slot_id]
        self.slots[slot_id] = None
        return slot

    def active_slots(self):
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def slot_of(self, rid: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                return i
        return None

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def busy(self) -> bool:
        return self.num_active > 0 or self.pending > 0
