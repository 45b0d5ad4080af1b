"""Continuous batching: a request queue feeding decode slots.

A copy of ``stochastic_gradient_push_tpu/serve/scheduler.py`` with no
change of behaviour.  ``tracer`` (anything with ``complete``) and
``registry`` (anything with ``emit``) stay optional; ``None`` records
nothing.

The serving loop that keeps the decode step full: requests queue FIFO,
admission moves the head of the queue into a free slot **whenever the
page table can cover its whole token budget** (prompt + max_new — the
up-front reservation means an admitted sequence can always finish),
and every :meth:`ContinuousBatcher.step` interleaves that admission
with one batched decode tick for all live slots.  Sequences finish and
free their pages mid-flight, which is precisely what re-opens
admission — continuous batching rather than static batches.

Capacity pressure is typed, never silent:

* a request that could **never** fit (budget beyond a slot's page
  window, or more pages than the pool has) is rejected at submit time
  with :class:`AdmissionError`;
* a request that merely can't fit *now* stays queued —
  ``serve.pages.PageCapacityError`` is the table's backpressure signal
  and the batcher treats it as "try again after a completion".

Telemetry is optional and host-side only: per-request spans on the
``request`` tracer phase, typed ``request`` events per completion and
``serve`` events for rejections (the JAX package's telemetry kinds).
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp
from collections import deque

from .pages import PageCapacityError

__all__ = ["AdmissionError", "Request", "Completion",
           "ContinuousBatcher"]


class AdmissionError(RuntimeError):
    """Permanent rejection: this request can never be served by this
    engine (token budget beyond the page window or the whole pool) —
    as opposed to the transient ``PageCapacityError`` backpressure."""


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int

    @property
    def budget_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    tokens: tuple[int, ...]      # generated tokens (prompt excluded)
    submitted_s: float
    admitted_s: float
    finished_s: float

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s

    @property
    def queue_s(self) -> float:
        return self.admitted_s - self.submitted_s


@dataclasses.dataclass
class _Live:
    request: Request
    slot: int
    tokens: list[int]
    submitted_s: float
    admitted_s: float


class ContinuousBatcher:
    """Drives an engine exposing ``can_admit/start/step/finish`` and a
    ``pages`` table (LMEngine, or the synthetic bench engine)."""

    def __init__(self, engine, tracer=None, registry=None,
                 clock: tp.Callable[[], float] = time.monotonic):
        self.engine = engine
        self.tracer = tracer
        self.registry = registry
        self.clock = clock
        self._pending: deque[tuple[Request, float]] = deque()
        self._live: dict[int, _Live] = {}          # slot -> in-flight
        self.completed: list[Completion] = []
        self.rejected = 0
        self.peak_occupancy = 0.0
        self.decode_steps = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue a request; reject (typed) what no amount of waiting
        could ever admit."""
        budget = request.budget_tokens
        table = self.engine.pages
        max_window = getattr(self.engine.config, "max_tokens_per_seq",
                             table.num_pages * table.page_size)
        if (request.max_new_tokens < 1 or budget > max_window
                or self.engine.required_pages(budget) > table.num_pages):
            self.rejected += 1
            if self.registry is not None:
                self.registry.emit(
                    "serve", {"phase": "reject", "id": request.rid,
                              "budget_tokens": budget,
                              "max_tokens_per_seq": max_window},
                    severity="warning")
            raise AdmissionError(
                f"request {request.rid} needs {budget} tokens "
                f"({len(request.prompt)} prompt + "
                f"{request.max_new_tokens} new); the engine serves at "
                f"most {max_window} per sequence")
        self._pending.append((request, self.clock()))

    # -- the serving loop --------------------------------------------------

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def active(self) -> int:
        return len(self._live)

    def step(self) -> list[Completion]:
        """One scheduler tick: admit-what-fits, then one decode pass
        over every live slot.  Returns the requests completed by this
        tick."""
        done: list[Completion] = []
        # 1. admission: prefill queue heads while capacity lasts (FIFO —
        #    a too-big head blocks, preserving order under backpressure)
        while self._pending:
            request, submitted = self._pending[0]
            if not self.engine.can_admit(request.budget_tokens):
                break
            t0 = self.clock()
            try:
                slot, first = self.engine.start(list(request.prompt),
                                                request.budget_tokens)
            except PageCapacityError:
                break      # transient: a completion will re-open this
            self._pending.popleft()
            admitted = self.clock()
            if self.tracer is not None:
                self.tracer.complete(f"prefill:{request.rid}", "serve",
                                     t0, admitted - t0,
                                     {"prompt_tokens": len(request.prompt)})
            live = _Live(request, slot, [first], submitted, admitted)
            if len(live.tokens) >= request.max_new_tokens:
                done.append(self._finish(live))
            else:
                self._live[slot] = live
        # 2. one decode tick for everything live
        if self._live:
            produced = self.engine.step(sorted(self._live))
            self.decode_steps += 1
            for slot, token in produced.items():
                live = self._live[slot]
                live.tokens.append(token)
                if len(live.tokens) >= live.request.max_new_tokens:
                    del self._live[slot]
                    done.append(self._finish(live))
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.engine.pages.occupancy())
        return done

    def drain(self, max_steps: int = 100_000) -> list[Completion]:
        """Run until the queue and every slot are empty; the page table
        must be quiescent afterwards (leaks raise)."""
        out: list[Completion] = []
        steps = 0
        while self._pending or self._live:
            out.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"drain did not converge in {max_steps} steps: "
                    f"{self.pending} pending, {self.active} live")
        self.engine.pages.assert_quiescent()
        return out

    # -- internals ---------------------------------------------------------

    def _finish(self, live: _Live) -> Completion:
        self.engine.finish(live.slot)
        comp = Completion(
            rid=live.request.rid, tokens=tuple(live.tokens),
            submitted_s=live.submitted_s, admitted_s=live.admitted_s,
            finished_s=self.clock())
        self.completed.append(comp)
        if self.tracer is not None:
            self.tracer.complete(
                f"request:{comp.rid}", "request", comp.submitted_s,
                comp.latency_s,
                {"prompt_tokens": len(live.request.prompt),
                 "new_tokens": len(comp.tokens),
                 "queue_s": comp.queue_s})
        if self.registry is not None:
            self.registry.emit(
                "request",
                {"id": comp.rid, "prompt_tokens": len(live.request.prompt),
                 "new_tokens": len(comp.tokens),
                 "latency_s": comp.latency_s, "queue_s": comp.queue_s})
        return comp
