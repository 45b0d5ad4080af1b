"""Synthetic traffic bench for the serving stack.

Port of ``stochastic_gradient_push_tpu/serve/bench.py``
(``SyntheticEngine``, ``synthetic_requests``, ``poisson_arrivals``,
``run_bench``, ``summarize``, ``write_artifact``).  The request streams
come from the
same numpy ``default_rng`` draws in the same order, so one seed gives
the same requests in both packages.  :func:`summarize` is the single
source of the serving numbers (tokens/sec, p50/p99 request latency, peak
page occupancy, admission rejections, modeled KV bytes/token, decode
steps): the CLI's printed lines and the artifact both come from it.

:class:`SyntheticEngine` is the reference's deterministic numpy engine
behind the slot API: it drives the page table as ``LMEngine`` does, with
token arithmetic in place of a model, so a set that holds no LM (a
ResNet run's files) still serves, and one seed gives the reference's
tokens and page ids.
"""

from __future__ import annotations

import json
import os
import time
import typing as tp

import numpy as np

from ..utils.meter import PercentileMeter
from .pages import PageTable, pages_for
from .scheduler import AdmissionError, ContinuousBatcher, Request

__all__ = ["SyntheticEngine", "synthetic_requests", "poisson_arrivals",
           "run_bench", "summarize", "write_artifact"]


class SyntheticEngine:
    """Deterministic token arithmetic behind the LMEngine slot API
    (``config`` a :class:`~.engine.ServeConfig`: the page shape)."""

    def __init__(self, config, vocab: int = 256, seed: int = 0,
                 kv_bytes_per_tok: int = 0):
        self.config = config
        self.vocab = int(vocab)
        self.seed = int(seed)
        self._kv_bytes = int(kv_bytes_per_tok)
        self.pages = PageTable(config.num_pages, config.page_size,
                               config.max_seqs)
        self._last: dict[int, int] = {}

    def can_admit(self, budget_tokens: int) -> bool:
        return (budget_tokens <= self.config.max_tokens_per_seq
                and self.pages.can_fit(budget_tokens))

    def required_pages(self, budget_tokens: int) -> int:
        return pages_for(budget_tokens, self.config.page_size)

    def start(self, prompt, budget_tokens: int):
        slot = self.pages.open(budget_tokens)
        self.pages.append(slot, len(prompt))
        tok = (self.seed + sum(prompt) + 31 * len(prompt)) % self.vocab
        self._last[slot] = tok
        return slot, tok

    def step(self, slots) -> dict[int, int]:
        out = {}
        for slot in slots:
            self.pages.append(slot, 1)
            tok = (self._last[slot] * 31 + slot + 7) % self.vocab
            self._last[slot] = tok
            out[slot] = tok
        return out

    def finish(self, slot: int) -> None:
        self._last.pop(slot, None)
        self.pages.close(slot)

    def kv_bytes_per_token(self) -> int:
        return self._kv_bytes


def synthetic_requests(n: int, seed: int = 0, vocab: int = 256,
                       prompt_tokens: tuple[int, int] = (4, 12),
                       new_tokens: tuple[int, int] = (2, 8)
                       ) -> list[Request]:
    """Deterministic request stream: uniform prompt/new-token lengths
    in the given inclusive ranges, token ids in ``[1, vocab)``."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(prompt_tokens[0], prompt_tokens[1] + 1))
        nnew = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        prompt = tuple(int(t) for t in rng.integers(1, vocab, size=plen))
        out.append(Request(rid=rid, prompt=prompt, max_new_tokens=nnew))
    return out


def poisson_arrivals(n: int, rate_hz: float, seed: int = 0) -> list[float]:
    """Arrival offsets (seconds from bench start) with exponential
    inter-arrival gaps — the open-loop Poisson stream."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n)).tolist()


def run_bench(engine, requests: list[Request],
              arrivals: list[float] | None = None, tracer=None,
              registry=None,
              clock: tp.Callable[[], float] = time.monotonic):
    """Serve ``requests`` to completion and return
    ``(metrics, completions)``.

    ``arrivals=None`` is the closed-loop mode: every request is queued
    up front and concurrency is whatever the page table admits.  With
    arrival offsets (:func:`poisson_arrivals`) the stream is open-loop
    against the real clock — except that fully-idle gaps are skipped
    (the bench measures serving, not sleeping), which only ever
    *shortens* queue waits.
    """
    batcher = ContinuousBatcher(engine, tracer=tracer, registry=registry,
                                clock=clock)
    if arrivals is None:
        arrivals = [0.0] * len(requests)
    if len(arrivals) != len(requests):
        raise ValueError(f"{len(arrivals)} arrival times for "
                         f"{len(requests)} requests")
    order = sorted(range(len(requests)), key=lambda i: arrivals[i])
    t0 = clock()
    skew = 0.0       # idle time skipped so far
    i = 0
    while i < len(order) or batcher.pending or batcher.active:
        now = clock() - t0
        while i < len(order) and arrivals[order[i]] - skew <= now:
            _submit(batcher, requests[order[i]])
            i += 1
        if not (batcher.pending or batcher.active):
            if i < len(order):
                # idle and the next arrival is in the future: skip the
                # dead air instead of spinning on the clock
                skew = max(skew, arrivals[order[i]] - now)
                continue
            break
        batcher.step()
    elapsed = clock() - t0
    completions = list(batcher.completed)
    kv_bytes = engine.kv_bytes_per_token() if hasattr(
        engine, "kv_bytes_per_token") else 0
    metrics = summarize(completions, elapsed,
                        rejected=batcher.rejected,
                        peak_occupancy=batcher.peak_occupancy,
                        kv_bytes_per_token=kv_bytes,
                        decode_steps=batcher.decode_steps)
    engine.pages.assert_quiescent()
    if registry is not None:
        registry.emit("serve", dict(metrics, phase="summary"))
    return metrics, completions


def _submit(batcher: ContinuousBatcher, request: Request) -> None:
    try:
        batcher.submit(request)
    except AdmissionError:
        pass     # typed permanent rejection; already counted + emitted


def summarize(completions, elapsed_s: float, rejected: int = 0,
              peak_occupancy: float = 0.0, kv_bytes_per_token: int = 0,
              decode_steps: int = 0) -> dict:
    """The serving bench numbers — one function, consumed by the bench
    artifact and the CLI's printed lines, so the two always agree."""
    lat = PercentileMeter(maxlen=65536, ptag="request_latency_s")
    tokens = 0
    for c in completions:
        lat.update(c.latency_s)
        tokens += len(c.tokens)
    elapsed_s = float(elapsed_s)
    return {
        "requests": len(completions),
        "tokens": tokens,
        "elapsed_s": elapsed_s,
        "tokens_per_sec": tokens / elapsed_s if elapsed_s > 0 else 0.0,
        "p50_latency_s": lat.p50,
        "p99_latency_s": lat.p99,
        "page_occupancy_peak": float(peak_occupancy),
        "admission_rejections": int(rejected),
        "kv_bytes_per_token": int(kv_bytes_per_token),
        "decode_steps": int(decode_steps),
    }


def write_artifact(path: str, metrics: dict, tracer=None,
                   extra: dict | None = None) -> str:
    """Write ``{"bench": metrics (+ extra), "trace": tracer.to_chrome()
    or []}`` as JSON, the JAX package's serving artifact layout."""
    out = dict(metrics)
    if extra:
        out.update(extra)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {"bench": out,
               "trace": tracer.to_chrome() if tracer is not None else []}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
