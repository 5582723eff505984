"""Heterogeneous speculative decoding across EMT technology corners (port
of :mod:`repro.serve.speculative`).

The draft and the target are the same weights on two placements of one
fabric.  A cheap deterministic ``sram_digital`` placement (amplitude-0
reads; quantization still applies) proposes ``k`` tokens per slot by
sequential greedy decodes; the analog target scores all of them in one
all-lane chunk step (:func:`repro_torch.serve.engine.verify_step`).  The
longest prefix of drafts that matches the target's per-lane argmax is
accepted, and the first mismatching lane's token is committed as the
correction (or, when all k match, the last lane's as a bonus), so every
committed token is the target's greedy token given its prefix: greedy
generation stays token-identical to plain decode on the target.

Why the analog energy falls at all: a (k+1)-lane verify pays each
crossbar tile's static activation energy once for k+1 positions, where
plain decode pays it per token; the acceptance rate decides whether the
rejected lanes' dynamic energy eats that saving.

Both placements bill into the engine's one ledger (total, idle and per
corner; the draft corner appears beside the analog ones), so per-request +
idle == total holds across both, for partial and cancelled requests too.
The draft subset is tracked per request (``draft_energy_pj``) and per
engine (``draft_total_energy_pj`` / ``draft_idle_energy_pj``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.placement import emt_for_corner
from repro_torch.models import lm
from repro_torch.models.context import Ctx
from repro_torch.serve import sampling
from repro_torch.serve.engine import GenResult, ServingEngine, verify_step


class SpeculativeEngine(ServingEngine):
    """A ServingEngine whose rounds draft ``spec_k`` tokens per slot on a
    cheap digital placement and verify them in one all-lane chunk step on
    the analog target.

    The draft runs the same parameters (``draft_params`` defaults to the
    target's) against a contiguous shadow KV cache that mirrors every write
    the target makes: prompt lanes lane for lane, committed tokens through
    the next round's draft decodes.

    Every target step is the same (k+1)-lane verify chunk: a slot still
    streaming its prompt fills its lanes with the next <= k+1 prompt tokens
    (the last lane's argmax is the first generated token when the prompt
    completes) while its co-tenants keep speculating, so the wide
    ``prefill_chunk`` step never runs.

    Greedy only (``temperature == 0``, checked in :meth:`validate`);
    chunked prefill is required (the verify step is a chunk step); no
    prefix cache (the draft cache cannot share blocks); all-global
    attention (a rejected draft's write into a sliding-window ring would
    destroy history that is never rewritten); one shard.
    """

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 draft_placement="sram_digital", spec_k: int = 4,
                 draft_params=None, **kw):
        if kw.get("n_shards", 1) > 1:
            raise ValueError("speculative decoding is not sharded yet: the "
                             "draft shadow cache and verify step are single-"
                             "device (n_shards must be 1)")
        super().__init__(cfg, params, batch_size, max_len, **kw)
        if not self.chunked:
            raise ValueError("speculative decoding requires chunked prefill "
                             "(the verify primitive is the chunk step)")
        if self.prefix_cache:
            raise ValueError("prefix_cache is not supported with speculative "
                             "decoding (the draft shadow cache cannot share "
                             "prefix blocks)")
        if self.cfg.sliding_window and "local" in self.cfg.blocks():
            raise ValueError("speculative decoding requires an all-global "
                             "attention stack (rejected drafts would clobber "
                             "sliding-window ring K/V)")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.spec_k = int(spec_k)
        if isinstance(draft_placement, str):
            draft_placement = emt_for_corner(draft_placement)
        self.draft_cfg = self.cfg.replace(emt=draft_placement)
        self.draft_params = params if draft_params is None else draft_params
        # contiguous shadow cache: the draft never pages
        self.draft_cache = lm.init_cache(self.draft_cfg, batch_size, max_len,
                                         device=self.device)
        # the draft-side ledger (a subset of the combined totals) and the
        # acceptance statistics
        self.draft_total_energy_pj = 0.0
        self.draft_idle_energy_pj = 0.0
        self.draft_steps = 0
        self.spec_rounds = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        # accept_len_hist[L]: verify rounds that accepted exactly L drafts
        self.accept_len_hist = np.zeros(self.spec_k + 1, np.int64)
        # slots whose draft cache is one position behind: a fully accepted
        # round commits the bonus token, whose predecessor d_k was proposed
        # but never decoded by the draft, so d_k's K/V at pos - 1 is
        # missing from the shadow cache; such a slot gets a one-lane
        # catch-up chunk write before its next draft
        self._draft_lag: dict = {}

    # -- request surface -----------------------------------------------------
    def validate(self, req) -> np.ndarray:
        prompt = super().validate(req)
        if req.temperature != 0:
            raise ValueError("SpeculativeEngine is greedy-only: the "
                             "acceptance rule compares argmaxes "
                             f"(got temperature={req.temperature})")
        return prompt

    @property
    def accept_rate(self) -> float:
        return self.spec_accepted_total / max(1, self.spec_proposed_total)

    # -- metrics -------------------------------------------------------------
    def reset_metrics(self):
        super().reset_metrics()
        self.draft_total_energy_pj = 0.0
        self.draft_idle_energy_pj = 0.0
        self.draft_steps = 0
        self.spec_rounds = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.accept_len_hist[:] = 0

    def metrics(self) -> dict:
        m = super().metrics()
        m.update(
            draft_total_energy_pj=float(self.draft_total_energy_pj),
            draft_idle_energy_pj=float(self.draft_idle_energy_pj),
            draft_steps=int(self.draft_steps),
            spec_rounds=int(self.spec_rounds),
            spec_proposed_total=int(self.spec_proposed_total),
            spec_accepted_total=int(self.spec_accepted_total),
            accept_rate=float(self.accept_rate),
            accept_len_hist=[int(v) for v in self.accept_len_hist])
        return m

    # -- draft-side bookkeeping ----------------------------------------------
    def _book_draft_step(self, aux, rows, prefill_rows=frozenset()) -> float:
        """Book one draft-placement step into the combined ledger (so the
        conservation invariant spans both placements) and into the draft
        split.  `rows` are the participating slots; the idle rows' share
        accrues to idle energy as on a target step."""
        self._steps += 1
        self.draft_steps += 1
        self.kv_reads_total += float(aux["kv_reads"])
        e = float(aux["energy_pj"])
        self._book_corners(aux["corners"])
        self.total_energy_pj += e
        self.draft_total_energy_pj += e
        share = e / self.batch_size
        idle = share * (self.batch_size - len(rows))
        self.idle_energy_pj += idle
        self.draft_idle_energy_pj += idle
        for i in rows:
            s = self.scheduler.slots[i]
            s.draft_energy_pj += share
            if i in prefill_rows:
                s.prefill_energy_pj += share
            else:
                s.energy_pj += share
        return share

    def _draft_sample_args(self):
        """Greedy sampling arguments for every row of a draft decode."""
        B = self.batch_size
        return (np.zeros(B, np.float32), np.zeros(B, np.int32),
                np.ones(B, np.float32), np.zeros(B, np.uint32),
                np.zeros(B, np.int32))

    # -- the speculative round -----------------------------------------------
    def _chunk_advance(self, active) -> List[GenResult]:
        # prompt lanes ride the verify chunk: the wide mixed step never runs
        return self._decode_advance(active)

    def _decode_advance(self, active) -> List[GenResult]:
        """One unified draft-k / verify-one round.

        Per decoding slot, up to ``k_eff`` drafts (k clamped to the slot's
        remaining token and cache budget, so verify writes never overrun
        the admission-time block reservation) by sequential greedy decodes
        on the draft placement; then one (k+1)-lane verify chunk
        ``[last_token, d_1 .. d_k_eff]`` at the slot's exact positions, and
        the longest greedy-matching prefix plus one target token are
        committed.  Rejected lanes' K/V is overwritten before any later
        query can attend it.  A slot still streaming its prompt fills its
        lanes with the next <= k+1 prompt tokens instead; the round that
        ends the prompt commits the last lane's argmax as the first
        generated token."""
        k = self.spec_k
        B, C = self.batch_size, self.spec_k + 1
        keff = {}
        prefill_take = {}
        for i, s in active:
            if s.prefilling:
                prefill_take[i] = min(C, len(s.prompt) - s.pos)
                keff[i] = 0
            else:
                total = min(len(s.prompt) + s.req.max_new - 1, self.max_len)
                remaining = s.req.max_new - len(s.generated)
                keff[i] = max(0, min(k, remaining - 1, total - 1 - s.pos))

        # ---- draft mirror: prompt lanes (write for write with the target)
        # and catch-up lanes for holes left by fully accepted rounds, in
        # one chunk step on the shadow cache
        lag_rows = [i for i, s in active
                    if not s.prefilling and self._draft_lag.pop(i, False)]
        mirror_rows = sorted(set(prefill_take) | set(lag_rows))
        if mirror_rows:
            tokm = np.zeros((B, C), np.int64)
            posm = np.zeros(B, np.int64)
            ntokm = np.ones(B, np.int64)
            actm = np.zeros(B, bool)
            for i in mirror_rows:
                s = self.scheduler.slots[i]
                actm[i] = True
                if i in prefill_take:
                    take = prefill_take[i]
                    tokm[i, :take] = s.prompt[s.pos:s.pos + take]
                    posm[i] = s.pos
                    ntokm[i] = take
                else:
                    tokm[i, 0] = s.generated[-2]
                    posm[i] = s.pos - 1
            _, self.draft_cache, aux = lm.chunk_step(
                self.draft_params, self.draft_cache, self._dev(tokm),
                self._dev(posm), self._dev(ntokm), self.draft_cfg,
                Ctx(seed=self._step_seed()), active=self._dev(actm))
            self._book_draft_step(aux, mirror_rows, frozenset(prefill_take))

        # ---- draft phase: sequential greedy proposals on the cheap corner
        drafts = {i: [] for i, _ in active}
        cur_tok = np.zeros(B, np.int64)
        cur_pos = np.zeros(B, np.int64)
        for i, s in active:
            cur_tok[i] = s.last_token
            cur_pos[i] = s.pos
        for j in range(max(keff.values(), default=0)):
            rows = [i for i, _ in active if keff[i] > j]
            if not rows:
                break
            act = np.zeros(B, bool)
            act[rows] = True
            logits, self.draft_cache, aux = lm.decode_step(
                self.draft_params, self.draft_cache, self._dev(cur_tok),
                self._dev(cur_pos), self.draft_cfg,
                Ctx(seed=self._step_seed()), active=self._dev(act))
            next_tok = sampling.sample_tokens(
                logits, *self._draft_sample_args()).cpu().numpy()
            self._book_draft_step(aux, rows)
            for i in rows:
                t = int(next_tok[i])
                drafts[i].append(t)
                cur_tok[i] = t
                cur_pos[i] += 1

        # ---- verify phase: one all-lane chunk step on the analog target
        tokens = np.zeros((B, C), np.int64)
        start = np.zeros(B, np.int64)
        ntok = np.ones(B, np.int64)
        act = np.zeros(B, bool)
        for i, s in active:
            act[i] = True
            start[i] = s.pos
            if i in prefill_take:
                take = prefill_take[i]
                tokens[i, :take] = s.prompt[s.pos:s.pos + take]
                ntok[i] = take
            else:
                row = [s.last_token] + drafts[i]
                tokens[i, :len(row)] = row
                ntok[i] = len(row)
        self.peak_concurrent = max(self.peak_concurrent, len(active))
        paged = {}
        if self.paged:
            # prompt lanes write inside the admission-time allocation; only
            # decode lanes can cross into reserved blocks
            for i, s in active:
                if i in prefill_take:
                    continue
                for p in range(s.pos, s.pos + int(ntok[i])):
                    if self.kv.ensure(i, p):
                        self._tables_dev = None
            paged = self._paged_tables(
                max(int(start[i] + ntok[i]) for i, _ in active))
        greedy, self.cache, aux = verify_step(
            self.params, self.cache, self._dev(tokens), self._dev(start),
            self._dev(ntok), self.cfg, Ctx(seed=self._step_seed()),
            active=self._dev(act), **paged)
        share = self._book_step(aux, active)
        greedy = greedy.cpu().numpy()            # (B, C) per-lane argmax

        # ---- host-side acceptance and commit
        finished = []
        for i, s in active:
            if i in prefill_take:
                take = prefill_take[i]
                s.prefill_energy_pj += share
                s.pos += take
                self.prefill_tokens_total += take
                if not s.prefilling:    # prompt done: the last lane's argmax
                    self._take_token(s, int(greedy[i, take - 1]))
                done = self._maybe_retire(i)
                if done is not None:
                    finished.append(done)
                continue
            s.energy_pj += share
            s.steps += 1
            m = keff[i]
            L = 0
            while L < m and drafts[i][L] == int(greedy[i, L]):
                L += 1
            # the accepted drafts, then the target's token for the first
            # mismatching lane (a correction when L < m, a bonus when L == m)
            commit = drafts[i][:L] + [int(greedy[i, L])]
            s.spec_proposed += m
            s.spec_accepted += L
            self.spec_proposed_total += m
            self.spec_accepted_total += L
            self.accept_len_hist[L] += 1
            self.spec_rounds += 1
            committed = 0
            for t in commit:
                s.pos += 1
                self._take_token(s, t)
                committed += 1
                if s.req.eos_id is not None and t == s.req.eos_id:
                    break
            if L == m and m > 0 and committed == len(commit):
                # full accept: d_m's K/V is missing from the draft cache
                self._draft_lag[i] = True
            done = self._maybe_retire(i)
            if done is not None:
                finished.append(done)
        return finished

    # -- retirement hygiene --------------------------------------------------
    def _retire(self, slot_id: int, reason: str) -> GenResult:
        # the shadow cache is zeroed on retirement as the target's is: a
        # backfilled slot must never attend the previous request's draft
        # K/V, rejected drafts' included
        self._draft_lag.pop(slot_id, None)
        for blk in self.draft_cache.values():
            for t in blk.values():
                t[slot_id] = 0.0
        return super()._retire(slot_id, reason)
