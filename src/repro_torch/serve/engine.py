"""Continuous-batching serving engine (port of :mod:`repro.serve.engine`
for one device).

A fixed batch of ``batch_size`` slots shares one KV cache: contiguous
(``paged=False``, the default, as in JAX), a ``(batch_size, max_len, ...)``
region per slot and layer, a window-sized ring on a sliding-window layer;
or paged (``paged=True``), per-layer block pools with per-slot block tables
(global layers) and per-slot rings of blocks (sliding-window layers,
``num_ring_blocks``).  A FIFO scheduler admits the queue head into a free
slot when the block budgets allow.  With chunked prefill (the default for
decoder-only stacks) its prompt then streams in ``prefill_chunk`` tokens
per step through the mixed chunk step
(:func:`repro_torch.models.lm.chunk_step`) while other slots decode one
token in the same step.  The legacy bucketed prefill (the only one for
encoder-decoder stacks, and ``chunked_prefill=False``) runs the prompt
alone at admission, left-padded into a power-of-two bucket
(:func:`prefill_bucket`), through :func:`repro_torch.models.lm.prefill`
into a contiguous batch-1 cache, copies that into the slot's region or
blocks (:func:`paged_insert`) and samples the first token from its logits;
the encoder of an enc-dec stack sees all-zero frame embeddings of the
bucket's length (the speech front end is a stub, as in the JAX engine).
Once no slot is prefilling, the engine runs the pure decode step
(:func:`repro_torch.models.lm.decode_step`): on the paged cache one fused
K/V-write + attention kernel per layer (and one read-only cross-attention
kernel per layer in an enc-dec stack), each step's global view clamped to
the block-rounded power-of-two bucket of the furthest live position
(:func:`view_bucket`).  A retiring slot's region or blocks are zeroed.

Energy: a step's ``energy_pj`` is split e / batch_size per row; idle rows'
share accrues to ``idle_energy_pj``, so per-request energy plus idle waste
equals the engine total.  ``corner_energy_pj`` books the same energy per
technology corner of the config's device placement (``pcm``, ``rram``,
...).  With ``fresh_noise=False`` the EMT fluctuation is frozen at the
engine seed and generation is a pure function of the request.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.serve import sampling
from repro_torch.serve.kv_pool import PagedKV
from repro_torch.serve.scheduler import RejectedError, Scheduler, Slot

__all__ = ["ServingEngine", "GenRequest", "GenResult", "RejectedError",
           "paged_insert", "prefill_bucket", "view_bucket"]


def view_bucket(need: int, block_size: int, max_len: int) -> int:
    """Block-rounded power-of-two view length covering `need` positions."""
    nb = 1
    while nb * block_size < need:
        nb *= 2
    return nb * block_size if nb * block_size < max_len else max_len


def prefill_bucket(n: int, lo: int = 4) -> int:
    """Smallest power of two >= n (at least `lo`): the legacy prefill's
    prompt bucket.  A prompt of length L occupies ``prefill_bucket(L)``
    cache positions (left-padded)."""
    b = lo
    while b < n:
        b *= 2
    return b


def paged_insert(cache, small, row_g, row_l=None,
                 ring=frozenset()) -> None:
    """Scatter a prefilled batch-1 contiguous cache into the pools, in
    place: every entry of layer ``small[name]`` (1, L, KV, hd), zero-padded
    to the row's blocks, lands in ``cache[name]`` at the block ids of
    `row_l` (the slot's ring table row) for the K/V of a layer named in
    `ring`, else of `row_g` (its global row); out-of-bounds ids
    (unallocated entries) are dropped.  The blocks' zero tails clear
    whatever their previous owner left."""
    for name, blk in cache.items():
        for key, pool in blk.items():
            rows = row_l if name in ring and key in ("k", "v") else row_g
            rows = torch.as_tensor(rows, dtype=torch.int64)
            nb, bs = pool.shape[:2]
            ok = rows < nb
            x = small[name][key][0].to(pool.dtype)
            width = rows.shape[0]
            x = F.pad(x, (0, 0, 0, 0, 0, width * bs - x.shape[0]))
            x = x.reshape(width, bs, *x.shape[1:])
            pool[rows[ok].to(pool.device)] = x[ok.to(x.device)]


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    temperature: float = 0.0         # 0 = greedy
    top_k: int = 0                   # 0 = disabled
    top_p: float = 1.0               # >= 1 = disabled
    seed: int = 0                    # sampling seed
    eos_id: Optional[int] = None


@dataclasses.dataclass
class GenResult:
    rid: int
    tokens: np.ndarray
    energy_pj: float
    prefill_energy_pj: float
    steps: int
    done_reason: str                 # eos | max_new | max_len | cancelled


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported with a later slice of the "
                               f"port (ROADMAP Queue 1, serving core)")


class ServingEngine:
    """Slot-based continuous-batching engine on one device.

    ``submit()`` enqueues a request and returns its rid, ``step()`` admits
    and advances every active slot one step and returns finished
    :class:`GenResult`s, ``drain()`` steps until idle, ``generate()`` is the
    batch wrapper.  `params` must live on `device`.  The paged pools
    default to as many positions as the contiguous regions:
    ``batch_size * ceil(max_len / block_size)`` global blocks and
    ``batch_size * ceil(window / block_size)`` ring blocks.
    """

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_len: int, seed: int = 0, fresh_noise: bool = True,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 num_ring_blocks: Optional[int] = None, placement=None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: int = 16, prefix_cache: bool = False,
                 n_shards: int = 1, max_pending: Optional[int] = None,
                 device="cuda"):
        if placement is not None:
            # a device placement (EMTConfig or DevicePlacement) overrides the
            # config's EMT surface for this engine; params must have been
            # built for the same placement
            cfg = cfg.replace(emt=placement)
        # chunked prefill streams prompts at their exact positions; an
        # enc-dec stack needs the encoder pass of the legacy bucketed path
        can_chunk = not cfg.is_encdec
        self.chunked = (can_chunk if chunked_prefill is None
                        else bool(chunked_prefill))
        if self.chunked and not can_chunk:
            raise ValueError("chunked_prefill requires a decoder-only "
                             "attention stack")
        if prefix_cache:
            raise _later("the prefix cache")
        if n_shards != 1:
            raise _later("sharded serving (n_shards > 1)")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk {prefill_chunk} < 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.seed = seed
        self.fresh_noise = fresh_noise
        self.prefill_chunk = int(prefill_chunk)
        self.block_size = block_size
        self.paged = bool(paged)
        self.kv = None
        if self.paged:
            self.page_lens = lm.paged_lens(cfg, max_len)
            ring_len = (self.page_lens["local"] if self.page_lens["ring"]
                        else 0)
            # default pools: as many positions as the contiguous regions
            if num_blocks is None:
                num_blocks = batch_size * -(-max_len // block_size)
            if not ring_len:
                num_ring_blocks = 0
            elif num_ring_blocks is None:
                num_ring_blocks = batch_size * -(-ring_len // block_size)
            self.kv = PagedKV(batch_size, max_len, block_size, num_blocks,
                              ring_len, num_ring_blocks)
            self.ring = lm.ring_layers(cfg, self.page_lens)
            self.cache = lm.init_paged_cache(
                cfg, batch_size, max_len, block_size, num_blocks,
                num_ring_blocks, device=self.device)
        else:
            self.cache = lm.init_cache(cfg, batch_size, max_len,
                                       device=self.device)
        self.scheduler = Scheduler(batch_size, self.kv,
                                   max_pending=max_pending)
        self.total_energy_pj = 0.0
        self.idle_energy_pj = 0.0
        self.corner_energy_pj = {}
        self.kv_reads_total = 0.0
        self.prefill_tokens_total = 0
        self._steps = 0              # global step counter (noise clock)
        self.peak_concurrent = 0
        self._tables_dev = None      # (view_len, tables) on device; None=stale
        self.view_len = 0

    # -- streaming API -------------------------------------------------------
    def _bucket_len(self, prompt_len: int) -> int:
        """Cache positions the prompt occupies: its exact length with chunked
        prefill; the legacy path left-pads into a power-of-two bucket, or
        prefills at the exact length when the bucket would leave no decode
        room."""
        if self.chunked:
            return prompt_len
        S = prefill_bucket(prompt_len)
        return prompt_len if S >= self.max_len else S

    def validate(self, req: GenRequest) -> np.ndarray:
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if not 1 <= len(prompt) <= self.max_len:
            raise ValueError(f"prompt length {len(prompt)} out of range "
                             f"[1, max_len={self.max_len}]")
        S = self._bucket_len(len(prompt))
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if not req.temperature >= 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {req.temperature}")
        if not req.top_p >= 0:
            raise ValueError(f"top_p must be >= 0, got {req.top_p}")
        if req.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {req.top_k}")
        if self.paged and not self.kv.fits(S, req.max_new):
            raise ValueError(f"request needs more KV blocks than the pool "
                             f"holds ({self.kv.pool_g.num_blocks} x "
                             f"{self.block_size})")
        return prompt

    def submit(self, req: GenRequest) -> int:
        self.validate(req)
        return self.scheduler.submit(req)

    def step(self) -> List[GenResult]:
        """Admit queued requests, then advance every active slot one step:
        a mixed chunk step while any slot is prefilling, else pure decode."""
        finished = self._admit_pending()
        active = self.scheduler.active_slots()
        if active:
            if any(s.prefilling for _, s in active):
                finished += self._chunk_advance(active)
            else:
                finished += self._decode_advance(active)
        return finished

    def _admit_pending(self) -> List[GenResult]:
        """FIFO admission into free slots, stopping at the first request the
        block budget cannot take."""
        finished = []
        while self.scheduler.pending:
            rid, req = self.scheduler.peek_pending()
            if not self.scheduler.can_admit(
                    self._bucket_len(len(req.prompt)), req.max_new):
                break
            self.scheduler.pop_pending()
            sid = self.scheduler.free_slot()
            self._admit(sid, rid, req)
            done = self._maybe_retire(sid)
            if done is not None:
                finished.append(done)
        return finished

    def _admit(self, sid: int, rid: int, req: GenRequest) -> None:
        """Bind `req` to slot `sid`.  Chunked: allocate its blocks and place
        it in the prefill phase.  Legacy: prefill it alone (batch 1, at the
        engine seed), scatter the cache into its blocks, book the prefill
        energy and sample the first token."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if self.chunked:
            if self.paged and not self.kv.admit(sid, len(prompt),
                                                req.max_new):
                raise RuntimeError("admission raced the block budget")
            self._tables_dev = None
            self.scheduler.place(sid, Slot(rid=rid, req=req, pos=0,
                                           last_token=0, prompt=prompt))
            return
        cfg = self.cfg
        S = self._bucket_len(len(prompt))
        toks = np.zeros((1, S), np.int64)
        toks[0, S - len(prompt):] = prompt               # left-padded
        batch = {"tokens": self._dev(toks)}
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.zeros((1, S, cfg.d_model),
                                              dtype=torch.float32,
                                              device=self.device)
        small = lm.init_cache(cfg, 1, self.max_len, device=self.device)
        small, logits, aux = lm.prefill(self.params, batch, cfg,
                                        Ctx(seed=self.seed), small)
        if self.paged:
            if not self.kv.admit(sid, S, req.max_new):
                raise RuntimeError("admission raced the block budget")
            self._tables_dev = None
            paged_insert(self.cache, small, *self.kv.scatter_rows(sid),
                         ring=self.ring)
        else:
            self._insert_slot(small, sid)
        prefill_e = float(aux["energy_pj"])
        self._book_corners(aux["corners"])
        self.total_energy_pj += prefill_e
        tok0 = int(sampling.sample_tokens(
            logits, np.asarray([req.temperature], np.float32),
            np.asarray([req.top_k], np.int32),
            np.asarray([req.top_p], np.float32),
            np.asarray([req.seed], np.uint32),
            np.zeros(1, np.int32))[0])
        self.scheduler.place(sid, Slot(
            rid=rid, req=req, pos=S, last_token=tok0, generated=[tok0],
            prefill_energy_pj=prefill_e,
            enc_len=S if cfg.is_encdec else 0))

    def _sampling_args(self, active):
        B = self.batch_size
        seeds = np.zeros(B, np.uint32)
        spos = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int32)
        topp = np.ones(B, np.float32)
        for i, s in active:
            seeds[i] = np.uint32(s.req.seed)
            spos[i] = s.sample_pos
            temps[i] = s.req.temperature
            topk[i] = s.req.top_k
            topp[i] = s.req.top_p
        return temps, topk, topp, seeds, spos

    def _dev(self, a):
        return torch.as_tensor(a, device=self.device)

    def _step_seed(self) -> int:
        return self.seed + self._steps + 1 if self.fresh_noise else self.seed

    def _decode_advance(self, active) -> List[GenResult]:
        B = self.batch_size
        tokens = np.zeros(B, np.int64)
        index = np.zeros(B, np.int64)
        act = np.zeros(B, bool)
        enc = np.zeros(B, np.int64)
        for i, s in active:
            tokens[i] = s.last_token
            index[i] = s.pos
            act[i] = True
            enc[i] = s.enc_len
        self.peak_concurrent = max(self.peak_concurrent, len(active))
        paged = {}
        if self.paged:
            for i, s in active:
                if self.kv.ensure(i, s.pos):
                    self._tables_dev = None
            paged = self._paged_tables(max(1 + s.pos for _, s in active))
        logits, self.cache, aux = lm.decode_step(
            self.params, self.cache, self._dev(tokens), self._dev(index),
            self.cfg, Ctx(seed=self._step_seed()), active=self._dev(act),
            enc_lens=self._dev(enc), **paged)
        next_tok = sampling.sample_tokens(
            logits, *self._sampling_args(active)).cpu().numpy()
        share = self._book_step(aux, active)
        finished = []
        for i, s in active:
            s.energy_pj += share
            s.steps += 1
            s.pos += 1
            self._take_token(s, int(next_tok[i]))
            done = self._maybe_retire(i)
            if done is not None:
                finished.append(done)
        return finished

    def _chunk_advance(self, active) -> List[GenResult]:
        B, C = self.batch_size, self.prefill_chunk
        tokens = np.zeros((B, C), np.int64)
        start = np.zeros(B, np.int64)
        ntok = np.ones(B, np.int64)
        act = np.zeros(B, bool)
        for i, s in active:
            act[i] = True
            start[i] = s.pos
            if s.prefilling:
                take = min(C, len(s.prompt) - s.pos)
                tokens[i, :take] = s.prompt[s.pos:s.pos + take]
                ntok[i] = take
            else:
                tokens[i, 0] = s.last_token
        self.peak_concurrent = max(self.peak_concurrent, len(active))
        paged = {}
        if self.paged:
            for i, s in active:
                if not s.prefilling and self.kv.ensure(i, s.pos):
                    self._tables_dev = None
            paged = self._paged_tables(
                max(int(start[i] + ntok[i]) for i, _ in active))
        logits, self.cache, aux = lm.chunk_step(
            self.params, self.cache, self._dev(tokens), self._dev(start),
            self._dev(ntok), self.cfg, Ctx(seed=self._step_seed()),
            active=self._dev(act), **paged)
        next_tok = sampling.sample_tokens(
            logits, *self._sampling_args(active)).cpu().numpy()
        share = self._book_step(aux, active)
        finished = []
        for i, s in active:
            if s.prefilling:
                s.prefill_energy_pj += share
                s.pos += int(ntok[i])
                self.prefill_tokens_total += int(ntok[i])
                if not s.prefilling:        # final chunk: first sampled token
                    self._take_token(s, int(next_tok[i]))
            else:
                s.energy_pj += share
                s.steps += 1
                s.pos += 1
                self._take_token(s, int(next_tok[i]))
            done = self._maybe_retire(i)
            if done is not None:
                finished.append(done)
        return finished

    def _take_token(self, s: Slot, t: int) -> None:
        s.last_token = t
        s.generated.append(t)

    def _paged_tables(self, need: int) -> dict:
        """The step's ``page_tables`` and ``page_lens``: the global table
        clamped to the view bucket covering `need` positions and the ring
        table (window-sized, never clamped), on device (re-uploaded only
        when they changed)."""
        vlen = view_bucket(need, self.block_size, self.max_len)
        if self._tables_dev is None or self._tables_dev[0] != vlen:
            width = -(-vlen // self.block_size)
            tg, tl = self.kv.gather_tables()
            self._tables_dev = (vlen, {
                "global": self._dev(np.ascontiguousarray(tg[:, :width])),
                "local": self._dev(tl)})
        self.view_len = vlen
        return {"page_tables": self._tables_dev[1],
                "page_lens": lm.clamped_lens(self.page_lens, vlen)}

    def _book_step(self, aux, active) -> float:
        """Book a step's aux; returns the per-active-slot energy share
        e / batch_size (idle rows' share is idle energy)."""
        self._steps += 1
        e = float(aux["energy_pj"])
        self.kv_reads_total += float(aux["kv_reads"])
        self._book_corners(aux["corners"])
        self.total_energy_pj += e
        share = e / self.batch_size
        self.idle_energy_pj += share * (self.batch_size - len(active))
        return share

    def _book_corners(self, corners) -> None:
        for name, c in corners.items():
            self.corner_energy_pj[name] = (self.corner_energy_pj.get(name, 0.0)
                                           + float(c["energy_pj"]))

    def cancel(self, rid: int, reason: str = "cancelled") -> Optional[GenResult]:
        """Cancel `rid` wherever it is: still queued (empty result) or bound
        to a slot (retired now with its partial tokens and energy)."""
        if self.scheduler.remove_pending(rid) is not None:
            return GenResult(rid=rid, tokens=np.zeros(0, np.int32),
                             energy_pj=0.0, prefill_energy_pj=0.0, steps=0,
                             done_reason=reason)
        slot_id = self.scheduler.slot_of(rid)
        if slot_id is None:
            return None
        return self._retire(slot_id, reason)

    def drain(self, stall_limit: int = 8) -> List[GenResult]:
        """Run step() until queue and slots are empty; raise after
        `stall_limit` steps in which nothing changed."""
        out = []
        stalled, last = 0, None
        while self.scheduler.busy:
            out.extend(self.step())
            snap = (self.scheduler.pending, len(out),
                    tuple((i, s.pos) for i, s in self.scheduler.active_slots()))
            if snap == last:
                stalled += 1
                if stalled >= stall_limit:
                    raise RuntimeError(
                        f"drain() made no progress for {stalled} steps: "
                        f"{self.scheduler.pending} pending, "
                        f"{self.scheduler.num_active} active" + (
                            f"; pool free={self.kv.pool_g.num_free}/"
                            f"{self.kv.pool_g.num_blocks}" if self.paged
                            else ""))
            else:
                stalled = 0
            last = snap
        return out

    # -- metrics -------------------------------------------------------------
    def reset_metrics(self):
        if self.scheduler.busy:
            raise RuntimeError("reset_metrics() requires an idle engine")
        self.total_energy_pj = 0.0
        self.idle_energy_pj = 0.0
        self.corner_energy_pj = {}
        self.kv_reads_total = 0.0
        self.prefill_tokens_total = 0
        self._steps = 0
        self.peak_concurrent = 0

    def metrics(self) -> dict:
        return {
            "total_energy_pj": float(self.total_energy_pj),
            "idle_energy_pj": float(self.idle_energy_pj),
            "corner_energy_pj": {k: float(v)
                                 for k, v in self.corner_energy_pj.items()},
            "steps": int(self._steps),
            "peak_concurrent": int(self.peak_concurrent),
            "kv_reads_total": float(self.kv_reads_total),
            "prefill_tokens_total": int(self.prefill_tokens_total),
        }

    def energy_conserved(self, results, rtol: float = 1e-6) -> bool:
        billed = float(sum(r.energy_pj for r in results))
        return bool(np.isclose(billed + self.idle_energy_pj,
                               self.total_energy_pj, rtol=rtol))

    def generate(self, requests):
        """Submit `requests` together and drain; returns (token arrays in
        submission order, energy billed to them).  Resets the noise clock."""
        if self.scheduler.busy:
            raise RuntimeError("generate() requires an idle engine")
        self._steps = 0
        rids = [self.submit(r) for r in requests]
        res = {r.rid: r for r in self.drain()}
        return ([np.asarray(res[rid].tokens) for rid in rids],
                float(sum(res[rid].energy_pj for rid in rids)))

    def serve(self, requests, stagger: int = 0) -> List[GenResult]:
        """Submit one request every `stagger` steps, then drain.  Results in
        submission order."""
        results = []
        for r in requests:
            self.submit(r)
            for _ in range(max(stagger, 0)):
                results += self.step()
        results += self.drain()
        return sorted(results, key=lambda r: r.rid)

    # -- internals -----------------------------------------------------------
    def _maybe_retire(self, slot_id: int) -> Optional[GenResult]:
        s = self.scheduler.slots[slot_id]
        if not s.generated:
            return None
        if s.req.eos_id is not None and s.generated[-1] == s.req.eos_id:
            reason = "eos"
        elif len(s.generated) >= s.req.max_new:
            reason = "max_new"
        elif s.pos >= self.max_len:
            reason = "max_len"
        else:
            return None
        return self._retire(slot_id, reason)

    def _insert_slot(self, small, slot: int) -> None:
        """Copy a prefilled batch-1 cache into slot `slot`'s contiguous
        region, zero-padding entries shorter than it (the legacy bucket's
        cross K/V)."""
        for name, blk in self.cache.items():
            for key, t in blk.items():
                v = small[name][key][0].to(t.dtype)
                t[slot] = F.pad(v, (0, 0, 0, 0, 0, t.shape[1] - v.shape[0]))

    def _retire(self, slot_id: int, reason: str) -> GenResult:
        """Release the slot; its cache region or blocks (global and ring)
        are zeroed before any reuse so a later request can never read its
        K/V."""
        slot = self.scheduler.retire(slot_id)
        if self.paged:
            freed_g, freed_l = self.kv.release(slot_id)
            self._tables_dev = None
            ids_g = self._dev(np.asarray(freed_g, np.int64))
            ids_l = self._dev(np.asarray(freed_l, np.int64))
            for name, blk in self.cache.items():
                for key, pool in blk.items():
                    ring = name in self.ring and key in ("k", "v")
                    pool[ids_l if ring else ids_g] = 0.0
        else:
            for blk in self.cache.values():
                for t in blk.values():
                    t[slot_id] = 0.0
        return GenResult(rid=slot.rid,
                         tokens=np.asarray(slot.generated, np.int32),
                         energy_pj=slot.prefill_energy_pj + slot.energy_pj,
                         prefill_energy_pj=slot.prefill_energy_pj,
                         steps=slot.steps, done_reason=reason)
