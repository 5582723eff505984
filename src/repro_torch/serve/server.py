"""Streaming front end over the continuous-batching engine (port of
:mod:`repro.serve.server`).

:class:`StreamingServer` turns the synchronous ``submit + step`` loop into
a request/response server: callers submit from any thread and get a
:class:`RequestHandle` that streams tokens as they are sampled, while one
serving thread owns the :class:`~repro_torch.serve.engine.ServingEngine`
and feeds ``step()`` from a bounded admission queue.

* **One serving loop.** The engine (scheduler, block pool, cache tensors)
  is not thread-safe, so every engine call happens on the serving thread:
  drain cancellations, expire deadlines, pump the admission queue into the
  engine's FIFO, then ``engine.step()``.  Callers never touch the engine;
  ``submit()`` runs only the read-only :meth:`ServingEngine.validate`.
  The kernels launch on the serving thread's current CUDA stream, which is
  the device's default stream unless the caller set another on that
  thread; the engine's own torch ops run on the same thread, so they share
  it.
* **Streaming.** The engine's ``on_token(rid, token)`` hook fires inside
  ``step()`` the moment a token is sampled; the server stamps it with a
  monotonic time and pushes it on the handle's queue, so TTFT and
  inter-token latency are measurable per request
  (:attr:`RequestHandle.ttft_s`, :attr:`RequestHandle.itl_s`).
* **Cancellation and deadlines.** ``handle.cancel()`` (or an expired
  ``deadline_s``) retires the request wherever it is: in the admission
  queue (empty result), in the engine's FIFO, or in a slot.  The partial
  result keeps the energy already billed, so per-request + idle == total
  holds.  ``done_reason`` is ``"cancelled"`` or ``"timeout"``.
* **Backpressure.** The admission queue is bounded (``max_pending``);
  ``submit()`` raises :class:`~repro_torch.serve.scheduler.RejectedError`
  when it is full.  The serving thread moves requests into the engine's FIFO only
  while that is shorter than the batch, so the block pool gates admission
  as in synchronous serving.

Usage::

    with StreamingServer(engine, max_pending=16) as srv:
        h = srv.submit(GenRequest(prompt=..., max_new=32), deadline_s=2.0)
        for tok in h.tokens():        # yields as sampled
            ...
        res = h.result()              # GenResult with its done_reason
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.serve.engine import GenRequest, GenResult, ServingEngine
from repro_torch.serve.scheduler import RejectedError

__all__ = ["StreamingServer", "RequestHandle", "RejectedError"]


class RequestHandle:
    """Caller-side view of one in-flight request: a stream of sampled tokens
    plus the final :class:`GenResult`.  Created by
    :meth:`StreamingServer.submit`; all fields are filled by the
    serving thread, all waiting happens on thread-safe queues/events."""

    def __init__(self, req: GenRequest, deadline_s: Optional[float]):
        self.req = req
        self.deadline_s = deadline_s
        self.t_submit = time.monotonic()   # arrival (queueing counts into TTFT)
        self.rid: Optional[int] = None     # engine rid once past the queue
        self.token_times: List[float] = [] # monotonic stamp per sampled token
        self._events: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._result: Optional[GenResult] = None
        self._cancel_reason: Optional[str] = None   # set by cancel()/deadline
        self._server: Optional["StreamingServer"] = None

    # -- caller API ----------------------------------------------------------
    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens as the engine samples them; returns at retirement.
        `timeout` bounds the wait for each next token (queue.Empty raised)."""
        while True:
            kind, payload = self._events.get(timeout=timeout)
            if kind == "done":
                return
            yield payload

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next streamed token, or None once the request is finished."""
        kind, payload = self._events.get(timeout=timeout)
        return payload if kind == "token" else None

    def result(self, timeout: Optional[float] = None) -> GenResult:
        """Block until the request finishes; returns its GenResult (partial
        tokens + billed energy for cancelled/timed-out requests)."""
        if not self._done.wait(timeout):
            raise TimeoutError("request still in flight")
        return self._result

    def cancel(self) -> None:
        """Request cancellation (asynchronous: the serving thread retires the slot on
        its next loop iteration; await result() for the partial)."""
        if self._server is not None:
            self._server._request_cancel(self, "cancelled")

    @property
    def done(self) -> bool:
        return self._done.is_set()

    # -- latency metrics -----------------------------------------------------
    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (includes queueing), or None if none arrived."""
        if not self.token_times:
            return None
        return self.token_times[0] - self.t_submit

    @property
    def itl_s(self) -> List[float]:
        """Inter-token latencies (gaps between consecutive sampled tokens)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    # -- serving side ----------------------------------------------------------
    def _push_token(self, token: int, t: float) -> None:
        self.token_times.append(t)
        self._events.put(("token", token))

    def _finish(self, result: GenResult) -> None:
        if self._done.is_set():
            return
        self._result = result
        self._events.put(("done", None))
        self._done.set()


class StreamingServer:
    """Bounded-admission streaming server over one :class:`ServingEngine`.

    The engine must be exclusively owned by this server while it runs (the
    serving thread is its only caller).  ``max_pending`` bounds the admission
    queue — the engine's own FIFO is additionally kept no longer than the
    batch, so at most ``max_pending + batch_size`` requests wait end-to-end.
    """

    def __init__(self, engine: ServingEngine, *, max_pending: int = 16,
                 poll_s: float = 0.001,
                 default_deadline_s: Optional[float] = None):
        self.engine = engine
        self.max_pending = int(max_pending)
        self.poll_s = float(poll_s)
        self.default_deadline_s = default_deadline_s
        self._lock = threading.Lock()          # guards _inbox + stats
        self._inbox: "deque[RequestHandle]" = deque()
        self._cancels: "deque[RequestHandle]" = deque()
        self._by_rid: dict = {}                # serving thread only
        self._stopping = False
        self._drain_on_stop = True
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.stats = {"submitted": 0, "rejected": 0, "completed": 0,
                      "cancelled": 0, "timeout": 0, "energy_budget": 0}
        engine.on_token = self._on_token

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamingServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._run,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the serving thread.  ``drain=True`` finishes everything in flight
        first; ``drain=False`` cancels outstanding requests instead."""
        if self._thread is None:
            return
        self._drain_on_stop = drain
        self._stopping = True
        self._thread.join()
        self._thread = None
        if self.error is not None:
            raise RuntimeError("serving thread crashed") from self.error

    def __enter__(self) -> "StreamingServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # -- caller API ----------------------------------------------------------
    def submit(self, req: GenRequest,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Enqueue `req`; returns its streaming handle.

        Raises ValueError for an invalid request (synchronously — the
        read-only engine validation runs on the calling thread) and
        :class:`RejectedError` when the bounded admission queue is full
        (backpressure: shed load or retry)."""
        self.engine.validate(req)
        handle = RequestHandle(
            req, self.default_deadline_s if deadline_s is None else deadline_s)
        handle._server = self
        with self._lock:
            if len(self._inbox) >= self.max_pending:
                self.stats["rejected"] += 1
                raise RejectedError(
                    f"admission queue full ({self.max_pending} pending)")
            self._inbox.append(handle)
            self.stats["submitted"] += 1
        return handle

    def _request_cancel(self, handle: RequestHandle, reason: str) -> None:
        with self._lock:
            if handle._cancel_reason is None and not handle.done:
                handle._cancel_reason = reason
                self._cancels.append(handle)

    # -- serving loop ---------------------------------------------------------
    def _run(self) -> None:
        eng = self.engine
        try:
            while True:
                self._do_cancels()
                self._expire_deadlines(time.monotonic())
                self._pump_inbox()
                if eng.scheduler.busy:
                    for res in eng.step():
                        self._finish_rid(res)
                elif self._stopping:
                    with self._lock:
                        empty = not self._inbox and not self._cancels
                    if empty or not self._drain_on_stop:
                        break
                else:
                    time.sleep(self.poll_s)
                if self._stopping and not self._drain_on_stop:
                    self._abort_outstanding()
                    break
        except BaseException as e:          # noqa: BLE001 — report, don't hang
            self.error = e
            try:
                self._abort_outstanding(reason="error")
            except BaseException:           # engine may be wedged: unblock
                for h in list(self._by_rid.values()):
                    h._finish(GenResult(
                        rid=h.rid if h.rid is not None else -1,
                        tokens=np.zeros(0, np.int32), energy_pj=0.0,
                        prefill_energy_pj=0.0, steps=0, done_reason="error"))
        finally:
            eng.on_token = None

    def _on_token(self, rid: int, token: int) -> None:
        h = self._by_rid.get(rid)
        if h is not None:
            h._push_token(token, time.monotonic())

    def _pump_inbox(self) -> None:
        """Move queued requests into the engine FIFO, at most batch_size deep
        — block-pool admission stays with the engine scheduler, and a caller
        rejection (bounded inbox) really means "the line is long"."""
        eng = self.engine
        while eng.scheduler.pending < eng.batch_size:
            with self._lock:
                if not self._inbox:
                    return
                h = self._inbox.popleft()
            if h.done:                       # cancelled/expired while queued
                continue
            h.rid = eng.submit(h.req)
            self._by_rid[h.rid] = h

    def _do_cancels(self) -> None:
        while True:
            with self._lock:
                if not self._cancels:
                    return
                h = self._cancels.popleft()
            self._cancel_now(h)

    def _cancel_now(self, h: RequestHandle) -> None:
        reason = h._cancel_reason or "cancelled"
        if h.done:
            return
        if h.rid is None:                    # never reached the engine
            res = GenResult(rid=-1, tokens=np.zeros(0, np.int32),
                            energy_pj=0.0, prefill_energy_pj=0.0, steps=0,
                            done_reason=reason)
        else:
            res = self.engine.cancel(h.rid, reason)
            if res is None:                  # raced a natural retirement
                return
        self._finish_rid(res, handle=h)

    def _expire_deadlines(self, now: float) -> None:
        with self._lock:
            live = list(self._by_rid.values()) + list(self._inbox)
        for h in live:
            if (h.deadline_s is not None and not h.done
                    and h._cancel_reason is None
                    and now - h.t_submit > h.deadline_s):
                h._cancel_reason = "timeout"
                self._cancel_now(h)

    def _finish_rid(self, res: GenResult,
                    handle: Optional[RequestHandle] = None) -> None:
        h = handle or self._by_rid.get(res.rid)
        if h is None:
            return                           # not server-submitted (warmup)
        if h.rid is not None:
            self._by_rid.pop(h.rid, None)
        key = res.done_reason if res.done_reason in (
            "cancelled", "timeout", "error", "energy_budget") else "completed"
        with self._lock:
            self.stats[key] = self.stats.get(key, 0) + 1
        h._finish(res)

    def _abort_outstanding(self, reason: str = "cancelled") -> None:
        for h in list(self._by_rid.values()):
            h._cancel_reason = h._cancel_reason or reason
            self._cancel_now(h)
        while True:
            with self._lock:
                if not self._inbox:
                    break
                h = self._inbox.popleft()
            h._cancel_reason = h._cancel_reason or reason
            self._cancel_now(h)
