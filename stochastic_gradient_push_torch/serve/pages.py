"""KV page table: fixed-size pages, free-list allocation, reservations.

A copy of ``stochastic_gradient_push_tpu/serve/pages.py`` with no change
of behaviour (the port imports nothing of the JAX package).

The decode engine's KV cache is a pool of fixed-size pages (``[heads,
num_pages, page_size, head_dim]`` per layer); a sequence holds an
ordered list of page ids and grows one token at a time.  This module is
the pure host-side bookkeeping for that pool — no torch, no tensors — so
the continuous-batching scheduler can reason about capacity without
touching the accelerator:

* **free-list allocation** — pages are recycled LIFO, so a hot serving
  loop reuses the most recently touched pages (and tests can pin the
  exact reuse order);
* **reservations** — admission reserves every page a request could
  *ever* need (prompt + max_new_tokens) up front, so a sequence that
  was admitted can always finish: capacity pressure surfaces as typed
  backpressure at admission time (:class:`PageCapacityError`), never as
  a mid-decode allocation failure;
* **leak accounting** — :meth:`PageTable.assert_quiescent` proves every
  page came home after a drain, the scheduler invariant the serving
  tests hold across hundreds of synthetic requests.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PageCapacityError", "PageTable"]


class PageCapacityError(RuntimeError):
    """Typed backpressure: the page pool (or slot table) cannot admit
    this sequence right now.  Transient — retry after sequences finish;
    the scheduler keeps the request queued instead of failing it."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries."""
    if tokens < 0:
        raise ValueError(f"negative token count {tokens}")
    return -(-tokens // page_size)


@dataclasses.dataclass
class _Seq:
    pages: list[int]
    length: int          # tokens held
    reserved: int        # pages reserved but not yet held


class PageTable:
    """Free-list page allocator with per-sequence page indices."""

    def __init__(self, num_pages: int, page_size: int, max_seqs: int):
        if num_pages < 1 or page_size < 1 or max_seqs < 1:
            raise ValueError(
                f"PageTable needs positive sizes, got num_pages="
                f"{num_pages} page_size={page_size} max_seqs={max_seqs}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_seqs = int(max_seqs)
        # LIFO free list: page reuse order is deterministic and warm
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: dict[int, _Seq] = {}

    # -- capacity ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return sum(s.reserved for s in self._seqs.values())

    @property
    def available_pages(self) -> int:
        """Pages neither held nor promised to an admitted sequence."""
        return len(self._free) - self.reserved_pages

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def occupancy(self) -> float:
        """Held fraction of the pool (the bench's occupancy gauge)."""
        return self.used_pages / self.num_pages

    def can_fit(self, tokens: int) -> bool:
        return (len(self._seqs) < self.max_seqs
                and pages_for(tokens, self.page_size)
                <= self.available_pages)

    # -- sequence lifecycle ------------------------------------------------

    def open(self, budget_tokens: int) -> int:
        """Admit a sequence with an up-front reservation covering its
        whole token budget; returns the slot id.  Raises
        :class:`PageCapacityError` (typed backpressure) when the pool or
        the slot table cannot take it now."""
        if len(self._seqs) >= self.max_seqs:
            raise PageCapacityError(
                f"all {self.max_seqs} decode slots busy")
        need = pages_for(budget_tokens, self.page_size)
        if need > self.available_pages:
            raise PageCapacityError(
                f"{need} page(s) needed for a {budget_tokens}-token "
                f"budget, {self.available_pages} available "
                f"({self.used_pages}/{self.num_pages} held, "
                f"{self.reserved_pages} reserved)")
        slot = next(i for i in range(self.max_seqs) if i not in self._seqs)
        self._seqs[slot] = _Seq(pages=[], length=0, reserved=need)
        return slot

    def append(self, slot: int, tokens: int = 1) -> None:
        """Grow a sequence by ``tokens`` KV entries, drawing pages from
        its reservation as boundaries are crossed."""
        seq = self._seq(slot)
        new_len = seq.length + int(tokens)
        need = pages_for(new_len, self.page_size) - len(seq.pages)
        if need > seq.reserved:
            raise PageCapacityError(
                f"slot {slot} grew past its admission budget: "
                f"{need} new page(s) wanted, {seq.reserved} reserved")
        for _ in range(need):
            seq.pages.append(self._free.pop())
            seq.reserved -= 1
        seq.length = new_len

    def close(self, slot: int) -> None:
        """Finish a sequence: every held page returns to the free list
        and the unused remainder of its reservation is released."""
        seq = self._seqs.pop(self._require(slot))
        for page in reversed(seq.pages):
            self._free.append(page)

    # -- views -------------------------------------------------------------

    @property
    def slots(self) -> list[int]:
        return sorted(self._seqs)

    def length(self, slot: int) -> int:
        return self._seq(slot).length

    def pages_of(self, slot: int) -> tuple[int, ...]:
        return tuple(self._seq(slot).pages)

    def last_position(self, slot: int) -> tuple[int, int]:
        """(page id, in-page offset) of the newest KV entry."""
        seq = self._seq(slot)
        if seq.length == 0:
            raise ValueError(f"slot {slot} holds no tokens yet")
        idx = seq.length - 1
        return seq.pages[idx // self.page_size], idx % self.page_size

    def page_index_array(self, slots, max_pages: int):
        """``[len(slots), max_pages]`` int32 page-id rows (padded with
        0 — padded entries are masked by the kernel's length guard)."""
        import numpy as np

        out = np.zeros((len(slots), max_pages), np.int32)
        for i, slot in enumerate(slots):
            pages = self._seq(slot).pages
            if len(pages) > max_pages:
                raise ValueError(
                    f"slot {slot} holds {len(pages)} pages > "
                    f"max_pages {max_pages}")
            out[i, :len(pages)] = pages
        return out

    def assert_quiescent(self) -> None:
        """Every page is home and no sequence is live (the no-leak
        invariant the scheduler tests hold after a drain)."""
        if self._seqs:
            raise AssertionError(
                f"live sequences remain: {sorted(self._seqs)}")
        if sorted(self._free) != list(range(self.num_pages)):
            missing = set(range(self.num_pages)) - set(self._free)
            raise AssertionError(f"leaked pages: {sorted(missing)}")

    # -- internals ---------------------------------------------------------

    def _require(self, slot: int) -> int:
        if slot not in self._seqs:
            raise KeyError(f"unknown slot {slot}; live: {self.slots}")
        return slot

    def _seq(self, slot: int) -> _Seq:
        return self._seqs[self._require(slot)]
