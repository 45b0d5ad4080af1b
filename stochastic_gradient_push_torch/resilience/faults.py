"""Deterministic fault injection at the gossip mixing boundary.

Port of ``stochastic_gradient_push_tpu/resilience/faults.py``: a textual
fault specification becomes seeded, deterministic mask tables that the
collectives apply inside the push-sum round.  The tables are the
reference's numpy tables, bit for bit (``_keep_corrupt_tables``,
``drop_random``'s ``default_rng(seed)`` field included).

Fault model (every fault is a window ``[t0, t1)`` of the step counter):

* **edge drop** — a directed edge ``src -> dst`` delivers nothing
  whenever the rotation activates it inside the window;
* **straggler** — a rank's outgoing messages all miss;
* **blackout** — a rank neither sends nor receives;
* **NaN corruption** — a rank's outgoing *payloads* become NaN (the
  push-sum weight lane stays finite, so its telemetry survives).

**Mass-conserving drops.**  When an out-edge is dropped the sender
reabsorbs the undelivered mixing weight into its local share: it keeps
``(lo + w_i)·x`` and ships nothing, so every column of the effective
matrix still sums to 1 and push-sum keeps the mean exactly
(:meth:`FaultPlan.effective_schedule`).  ``reabsorb=False`` builds
mass-leaking masks, for tests that prove the monitor sees a leak.

**The tick.**  The port's tick is a host int, so :meth:`FaultMasks.
keep_at` and :meth:`FaultMasks.corrupt_at` return host rows (one value
per rank); the collectives turn a round's rows into device tensors once
per round.  Overlap rounds look the rows up at their *launch* tick.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..topology.schedule import GossipSchedule

__all__ = ["FaultEvent", "FaultPlan", "FaultMasks", "parse_fault_spec"]

_KINDS = ("drop", "drop_random", "straggler", "blackout", "nan")

# an open-ended window stays active forever: past the per-tick horizon
# the lookup switches to per-phase steady-state rows where only
# open-ended events apply, resolved against each phase's permutation
_OPEN = -1


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault clause: what breaks, for whom, over which step window."""

    kind: str               # one of _KINDS
    start: int              # first step (tick) the fault is active
    end: int                # one past the last active step; _OPEN = forever
    rank: int = -1          # subject rank (straggler/blackout/nan)
    src: int = -1           # edge drop: sending rank
    dst: int = -1           # edge drop: destination rank
    prob: float = 0.0       # drop_random: per-edge per-step drop probability

    def active(self, tick: int) -> bool:
        return tick >= self.start and (self.end == _OPEN or tick < self.end)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "start": self.start,
             "end": None if self.end == _OPEN else self.end}
        if self.kind == "drop":
            d.update(src=self.src, dst=self.dst)
        elif self.kind == "drop_random":
            d["prob"] = self.prob
        else:
            d["rank"] = self.rank
        return d


def _parse_window(tail: str, kind: str) -> tuple[int, int]:
    """``@T0:T1`` window suffix; missing = open-ended from step 0."""
    if not tail:
        if kind == "drop_random":
            raise ValueError(
                "drop_random requires a bounded @T0:T1 window (the "
                "steady state past the horizon is deterministic)")
        return 0, _OPEN
    if ":" not in tail:
        raise ValueError(f"fault window {tail!r} must be T0:T1")
    lo, hi = tail.split(":", 1)
    start, end = int(lo), int(hi)
    if start < 0 or end <= start:
        raise ValueError(f"fault window {tail!r} must satisfy 0 <= T0 < T1")
    return start, end


def parse_fault_spec(spec: str) -> "FaultPlan":
    """Parse an ``--inject_faults`` specification into a :class:`FaultPlan`.

    Semicolon-separated clauses, each ``kind:args[@T0:T1]`` with step
    windows ``[T0, T1)`` (omitted = from step 0, forever):
    ``drop:SRC->DST``, ``drop_random:P`` (bounded window only),
    ``straggler:R``, ``blackout:R``, ``slice:A-B`` (ranks A..B all black
    out), ``nan:R`` and ``seed:N`` (drop_random's seed, default 0).
    Example: ``drop:0->1@10:40;slice:4-7@20:30;seed:7``.
    """
    events: list[FaultEvent] = []
    seed = 0
    for raw in spec.split(";"):
        clause = raw.strip()
        if not clause:
            continue
        if ":" not in clause:
            raise ValueError(
                f"fault clause {clause!r} must be kind:args[@T0:T1]")
        kind, rest = clause.split(":", 1)
        kind = kind.strip()
        if kind == "seed":
            seed = int(rest)
            continue
        if kind not in _KINDS and kind != "slice":
            raise ValueError(
                f"unknown fault kind {kind!r}; one of {_KINDS}, "
                "slice, or seed")
        body, _, window = rest.partition("@")
        start, end = _parse_window(window, kind)
        if kind == "slice":
            # a whole slice of ranks blacks out together: one blackout
            # event per rank
            if "-" not in body:
                raise ValueError(f"slice needs A-B rank bounds, got "
                                 f"{body!r}")
            lo, hi = body.split("-", 1)
            lo, hi = int(lo), int(hi)
            if lo < 0 or hi < lo:
                raise ValueError(
                    f"slice bounds {body!r} must satisfy 0 <= A <= B")
            events.extend(FaultEvent("blackout", start, end, rank=r)
                          for r in range(lo, hi + 1))
        elif kind == "drop":
            if "->" not in body:
                raise ValueError(
                    f"drop needs SRC->DST, got {body!r}")
            src, dst = body.split("->", 1)
            events.append(FaultEvent(kind, start, end,
                                     src=int(src), dst=int(dst)))
        elif kind == "drop_random":
            prob = float(body)
            if not 0.0 <= prob <= 1.0:
                raise ValueError(f"drop_random probability {prob} "
                                 "outside [0, 1]")
            events.append(FaultEvent(kind, start, end, prob=prob))
        else:
            events.append(FaultEvent(kind, start, end, rank=int(body)))
    if not events:
        raise ValueError(f"fault spec {spec!r} contains no fault clauses")
    return FaultPlan(events=tuple(events), seed=seed)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded set of :class:`FaultEvent` windows (host
    data); :meth:`build_masks` compiles it against a schedule."""

    events: tuple[FaultEvent, ...]
    seed: int = 0

    def horizon(self) -> int:
        """Per-tick mask rows: one past the last bounded window, so the
        lookup reaches the steady-state rows once every bounded fault has
        ended."""
        ends = [e.end + 1 for e in self.events if e.end != _OPEN]
        starts = [e.start + 1 for e in self.events]
        return max(ends + starts + [1])

    def validate(self, world: int) -> None:
        for e in self.events:
            for r in (e.rank, e.src, e.dst):
                if r != -1 and not 0 <= r < world:
                    raise ValueError(
                        f"fault {e.to_dict()} names rank {r} outside "
                        f"world {world}")
            if e.kind == "drop" and e.src == e.dst:
                raise ValueError("drop edge must have src != dst")

    def _apply_events(self, keep_row, corrupt_row, dests, ppi,
                      events, rand_row) -> None:
        """Mask one (phase-resolved) row in place for ``events``."""
        for e in events:
            if e.kind == "drop":
                for i in range(ppi):
                    if dests[i, e.src] == e.dst:
                        keep_row[i, e.src] = 0.0
            elif e.kind == "drop_random":
                keep_row[rand_row < e.prob] = 0.0
            elif e.kind == "straggler":
                keep_row[:, e.rank] = 0.0
            elif e.kind == "blackout":
                keep_row[:, e.rank] = 0.0           # sends nothing
                for i in range(ppi):                # receives nothing
                    keep_row[i, dests[i] == e.rank] = 0.0
            elif e.kind == "nan":
                corrupt_row[e.rank] = 1.0

    def _keep_corrupt_tables(self, schedule: GossipSchedule, horizon: int,
                             gossip_every: int = 1
                             ) -> tuple[np.ndarray, np.ndarray]:
        """keep ``(horizon + num_phases, ppi, world)`` and corrupt
        ``(horizon + num_phases, world)`` float32.  Rows ``t <
        horizon`` resolve faults against the permutation of phase ``(t
        // gossip_every) % num_phases``; row ``horizon + p`` is phase
        ``p``'s steady state (open-ended events only)."""
        ppi, n = schedule.peers_per_itr, schedule.world_size
        num_phases = schedule.num_phases
        rows = horizon + num_phases
        keep = np.ones((rows, ppi, n), dtype=np.float32)
        corrupt = np.zeros((rows, n), dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        # one random field for the whole horizon: the draw order never
        # depends on which windows are active
        rand = rng.random((horizon, ppi, n))
        for t in range(horizon):
            p = (t // gossip_every) % num_phases
            active = [e for e in self.events if e.active(t)]
            self._apply_events(keep[t], corrupt[t], schedule.perms[p],
                               ppi, active, rand[t])
        open_events = [e for e in self.events if e.end == _OPEN]
        for p in range(num_phases):
            self._apply_events(keep[horizon + p], corrupt[horizon + p],
                               schedule.perms[p], ppi, open_events,
                               np.ones((ppi, n)))
        return keep, corrupt

    def build_masks(self, schedule: GossipSchedule, reabsorb: bool = True,
                    gossip_every: int = 1) -> "FaultMasks":
        """The plan compiled against ``schedule``.  ``gossip_every`` must
        be the algorithm's thinning factor (the rotation at step ``t`` is
        ``(t // gossip_every) % num_phases``); the algorithm checks it.
        ``reabsorb=False`` builds mass-leaking masks (tests only)."""
        keep, corrupt, horizon = self.host_tables(schedule, gossip_every)
        return FaultMasks(keep=keep, corrupt=corrupt, horizon=horizon,
                          num_phases=schedule.num_phases,
                          gossip_every=gossip_every,
                          reabsorb=reabsorb, plan=self)

    def host_tables(self, schedule: GossipSchedule, gossip_every: int = 1
                    ) -> tuple[np.ndarray, np.ndarray, int]:
        """``(keep, corrupt, horizon)``: the tables of
        :meth:`build_masks`; row ``t`` while ``t < horizon``, then
        ``horizon + phase(t)``."""
        if gossip_every < 1:
            raise ValueError("gossip_every must be >= 1")
        self.validate(schedule.world_size)
        horizon = self.horizon()
        keep, corrupt = self._keep_corrupt_tables(schedule, horizon,
                                                  gossip_every)
        return keep, corrupt, horizon

    def effective_schedule(self, schedule: GossipSchedule, tick: int,
                           gossip_every: int = 1) -> GossipSchedule:
        """The faulted mixing tables at ``tick`` as a one-phase
        :class:`GossipSchedule`: edge weights keep-masked, the dropped
        weight reabsorbed into the self weight."""
        horizon = self.horizon()
        keep, _ = self._keep_corrupt_tables(schedule, horizon,
                                            gossip_every)
        p = (tick // gossip_every) % schedule.num_phases
        row = tick if tick < horizon else horizon + p
        k = keep[row]                          # (ppi, world)
        edge_w = schedule.edge_weights[p] * k
        self_w = (schedule.self_weight[p]
                  + (schedule.edge_weights[p] * (1.0 - k)).sum(axis=0))
        return GossipSchedule(
            perms=schedule.perms[p][None],
            self_weight=self_w[None],
            edge_weights=edge_w[None],
            regular=False,
            world_size=schedule.world_size,
            peers_per_itr=schedule.peers_per_itr,
            num_phases=1)

    def effective_matrix(self, schedule: GossipSchedule, tick: int,
                         gossip_every: int = 1) -> np.ndarray:
        """Dense column-stochastic mixing matrix applied at ``tick``."""
        return self.effective_schedule(schedule, tick,
                                       gossip_every).mixing_matrix(0)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    def summary(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


class FaultMasks:
    """The mask tables of one (plan, schedule) pair, on the host.

    ``keep_at`` and ``corrupt_at`` take the round's host tick and return
    one value per rank: row ``tick`` within the horizon, the per-phase
    steady-state row ``horizon + phase(tick)`` past it."""

    def __init__(self, keep: np.ndarray, corrupt: np.ndarray,
                 horizon: int, num_phases: int, gossip_every: int,
                 reabsorb: bool, plan: FaultPlan):
        self.horizon = int(horizon)
        self.num_phases = int(num_phases)
        self.gossip_every = int(gossip_every)
        self.reabsorb = bool(reabsorb)
        self.plan = plan
        self.any_corruption = bool(corrupt.any())
        self._keep = np.asarray(keep, np.float32)
        self._corrupt = np.asarray(corrupt, np.float32)
        self._on_device: dict = {}

    def keep_host(self) -> np.ndarray:
        """The keep table ``(horizon + num_phases, ppi, world)`` (comm
        accounting and tests)."""
        return self._keep

    def _row(self, tick: int) -> int:
        t = int(tick)
        if t < self.horizon:
            return t
        return self.horizon + (t // self.gossip_every) % self.num_phases

    def keep_at(self, tick: int, sub_round: int) -> np.ndarray:
        """float32 ``[world]`` in {0, 1}: does each rank's
        ``sub_round``-th message go out at ``tick``?"""
        return self._keep[self._row(tick), sub_round]

    def corrupt_at(self, tick: int) -> np.ndarray:
        """float32 ``[world]`` in {0, 1}: are each rank's outgoing
        payloads NaN-poisoned at ``tick``?"""
        return self._corrupt[self._row(tick)]

    def rows_on(self, tick: int, device) -> tuple:
        """The round's rows at ``tick`` as ``device`` tensors: keep
        ``[ppi, world]`` and corrupt ``[world]`` (None without
        corruption).  The whole tables go to the device once; a round
        then indexes them there, with no copy from the host."""
        key = str(device)
        tables = self._on_device.get(key)
        if tables is None:
            tables = (torch.from_numpy(self._keep).to(device),
                      torch.from_numpy(self._corrupt).to(device))
            self._on_device[key] = tables
        row = self._row(tick)
        return (tables[0][row],
                tables[1][row] if self.any_corruption else None)
