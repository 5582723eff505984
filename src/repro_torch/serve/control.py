"""Energy-aware control plane for the serving engine (port of
:mod:`repro.serve.control`; host side, pure Python).

Two scopes:

* **Per-request SLA** (:attr:`repro_torch.serve.engine.GenRequest.
  energy_budget_uj`): after every engine step the controller compares the
  energy billed to each active slot (prefill + decode share, and a
  speculative engine's draft share, which its ledger books into the same
  two) with its budget and sheds an exhausted request through the
  engine's cancel path
  with ``done_reason="energy_budget"``; its partial tokens and billed
  energy ride out on the result, so per-request + idle == total still
  holds.  The shed is post hoc: the step that crossed the budget is billed,
  so the overrun is at most one step's share.
* **Per-engine admission** (a rolling uJ bucket): the engine earns
  ``step_budget_uj`` of credit per step up to a ``burst_uj`` cap, and every
  step's booked energy (both placements' steps of a speculative engine)
  is debited.  While the bucket is overdrawn,
  admission of new requests head-blocks in the FIFO like the paged block
  budget; admitted requests are never shed by the bucket.  An engine with
  no active slot always admits, so the clock that refills the bucket never
  stalls.

One controller serves one engine (it tracks the engine's step and energy
counters by delta): ``ServingEngine(..., controller=...)``.
"""
from __future__ import annotations

from typing import List, Optional


class EnergyBudgetController:
    """uJ-budget admission gate + per-request energy-SLA shedding."""

    def __init__(self, step_budget_uj: Optional[float] = None,
                 burst_uj: Optional[float] = None):
        if step_budget_uj is not None and not step_budget_uj > 0:
            raise ValueError(f"step_budget_uj must be > 0, "
                             f"got {step_budget_uj}")
        self.step_budget_uj = step_budget_uj
        # default burst: 16 steps of credit — enough to absorb a prefill
        # burst without letting the engine run unboundedly hot
        if burst_uj is None and step_budget_uj is not None:
            burst_uj = 16.0 * step_budget_uj
        self.burst_uj = burst_uj
        # the bucket starts full: a fresh engine may spend its burst
        self.balance_uj = burst_uj if burst_uj is not None else 0.0
        self._seen_steps = 0
        self._seen_energy_pj = 0.0
        # observability counters (read by benches/tests/the launch report)
        self.shed = 0                # requests shed on their own budget
        self.deferred_steps = 0      # admission attempts deferred by the bucket

    # -- bucket bookkeeping --------------------------------------------------
    def _sync(self, engine) -> None:
        """Fold the engine's progress since the last look into the bucket:
        credit per new engine step, debit the energy booked meanwhile."""
        if self.step_budget_uj is None:
            return
        dsteps = engine._steps - self._seen_steps
        de_pj = engine.total_energy_pj - self._seen_energy_pj
        self._seen_steps = engine._steps
        self._seen_energy_pj = engine.total_energy_pj
        self.balance_uj = min(
            self.burst_uj,
            self.balance_uj + dsteps * self.step_budget_uj) - de_pj * 1e-6

    # -- engine hooks --------------------------------------------------------
    def may_admit(self, engine) -> bool:
        """Admission gate, called per queued request from the engine's FIFO
        admission loop.  False head-blocks the queue this step."""
        if self.step_budget_uj is None:
            return True
        self._sync(engine)
        if engine.scheduler.num_active == 0:
            return True              # idle engine: never deadlock the clock
        if self.balance_uj <= 0.0:
            self.deferred_steps += 1
            return False
        return True

    def over_budget(self, engine) -> List[int]:
        """Rids of active requests whose billed energy exceeded their own
        energy_budget_uj — the engine cancels them with
        ``done_reason="energy_budget"`` after each step."""
        self._sync(engine)
        shed = []
        for _, s in engine.scheduler.active_slots():
            budget = getattr(s.req, "energy_budget_uj", None)
            if budget is None:
                continue
            billed_uj = (s.prefill_energy_pj + s.energy_pj) * 1e-6
            if billed_uj >= budget:
                shed.append(s.rid)
        self.shed += len(shed)
        return shed
