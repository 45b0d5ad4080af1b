"""Pod-level fleet coordination: rendezvous, shard assignment, relaunch.

Port of ``stochastic_gradient_push_tpu/supervise/coordinator.py``; the
protocol, its events and their fields are the reference's, field for
field.  The single-host :class:`~.supervisor.Supervisor` keeps one child
alive on one host.  A pod is a *fleet*: one supervisor per host, each
owning that host's slice of the gossip world, plus this module's
:class:`Coordinator` deciding — once, for everybody — who reshards and
who relaunches which host when the unit of failure is a whole host or
slice (the reference's SLURM/ClusterManager substrate and GossipGraD's
failure model both assume exactly that granularity).

Transport is the typed event stream the supervisor already speaks,
over the shared filesystem a SLURM/ClusterManager pod already has —
no sockets, no extra daemons:

* host → coordinator: each per-host supervisor's own
  ``host{h}/supervisor.jsonl`` (kind ``rendezvous``: hello / alive /
  fault / join / ack / done), tailed by the coordinator with the same
  rotation-safe :class:`~.tailer.EventTailer` it tails children with;
* coordinator → hosts: one broadcast stream, ``coordinator.jsonl``
  (kind ``rendezvous`` for barrier calls, kind ``fleet`` for
  decisions: assign / go / complete / halt / give-up), tailed by every
  host supervisor.

The two directions never share a file, so nobody reads back its own
writes — the same discipline that keeps ``supervisor.jsonl`` separate
from the child's ``events.jsonl``.

The relaunch cycle is a barrier-with-deadline rendezvous followed by a
two-phase commit:

1. **call** — on a host fault report or host silence past the timeout,
   the coordinator opens round *r*: every host believed live must drain
   (or bury) its child and ``join`` round *r* before the deadline.
   Hosts join *after* the drain lands — the drain's save is the shard
   boundary — so the configured deadline must cover the child's
   checkpoint time, not just message latency;
2. **exclude & re-run** — hosts that miss the deadline are excluded
   from the world and the rendezvous re-runs at the smaller membership
   (a dead host can never hang the fleet; a slow host gets exactly the
   deadline);
3. **assign** — the survivors' rows define the new world.  The
   coordinator re-plans ONCE (:mod:`.replan` — the same stamped
   constraints ``Supervisor._replan`` uses: fabric, wire codec, synth
   spec, faults) and broadcasts each survivor's ``out_rank``/
   ``out_rows`` shard of the cross-world reshard;
4. **ack** — each survivor runs
   :func:`~.reshard.reshard_checkpoints` for its own shard
   *concurrently* and acks with its measured boundary drift.  Where the
   reference writes one file a host (``out_rank``) holding ``out_rows``
   rows, the port writes one file a rank: host ``out_rank``'s shard is
   the rank files ``rank_offset .. rank_offset + out_rows - 1``.  The
   writes are atomic and disjoint, so they compose into one set, and a
   missing or mixed rank file makes the set torn.  A survivor that never acks is excluded and the
   cycle re-runs;
5. **go** — when every survivor acked, the coordinator commits the
   generation; only then do hosts relaunch their children.  Exactly
   one coordinated cycle per cause — no per-host relaunch storm.
"""

from __future__ import annotations

import os
import signal
import time

from ..telemetry import (
    COORDINATOR_EVENTS_FILE,
    JsonlSink,
    LoggerCompatSink,
    SUPERVISOR_EVENTS_FILE,
    TelemetryRegistry,
)
from ..utils.checkpoint import REQUEUE_EXIT_CODE
from ..utils.logging import make_logger
from .replan import replan_for, stamped_plan
from .tailer import EventTailer

__all__ = ["Coordinator", "FleetMember", "host_dir",
           "EXCLUDED_EXIT_CODE"]

# a live host that joined the rendezvous but was excluded by the
# assignment (e.g. it joined a superseded round) exits with this code:
# its work was reassigned, the run continues without it — not a crash
# (1), not a requeue request (75)
EXCLUDED_EXIT_CODE = 4


def host_dir(fleet_dir: str, host: int) -> str:
    """Host ``h``'s corner of the shared fleet directory: its child's
    ``events.jsonl`` and its supervisor's ``supervisor.jsonl``."""
    return os.path.join(fleet_dir, f"host{int(host)}")


# -- host side ---------------------------------------------------------------


class FleetMember:
    """The host-side half of the protocol: emit helpers bound to the
    per-host supervisor's own registry (so rendezvous messages land in
    ``host{h}/supervisor.jsonl`` next to its lifecycle events) plus a
    tailer on the coordinator's broadcast stream."""

    def __init__(self, fleet_dir: str, host: int, rows: int, *,
                 alive_interval_s: float = 2.0):
        if rows < 1:
            raise ValueError(f"host {host} must own >= 1 rank rows, "
                             f"got {rows}")
        self.fleet_dir = fleet_dir
        self.host = int(host)
        self.rows = int(rows)
        self.alive_interval_s = float(alive_interval_s)
        self.tailer = EventTailer(
            os.path.join(fleet_dir, COORDINATOR_EVENTS_FILE))
        self._registry: TelemetryRegistry | None = None
        self._last_alive = 0.0

    def bind(self, registry: TelemetryRegistry) -> None:
        self._registry = registry

    def emit(self, phase: str, severity: str = "info", **data) -> None:
        if self._registry is None:
            raise RuntimeError("FleetMember.bind(registry) must run "
                               "before any emit")
        self._registry.emit("rendezvous",
                            {"phase": phase, "host": self.host, **data},
                            severity=severity)

    # the protocol's host->coordinator vocabulary
    def hello(self, world: int, generation: int, child_pid: int) -> None:
        self.emit("hello", world=world, generation=generation,
                  rows=self.rows, child_pid=child_pid)
        self._last_alive = time.time()

    def maybe_alive(self, child_pid: int | None) -> None:
        """Heartbeat on a cadence — the coordinator's liveness signal
        (and, via ``child_pid``, the handle slice-kill chaos tooling
        uses to bury the whole simulated host)."""
        now = time.time()
        if now - self._last_alive >= self.alive_interval_s:
            self._last_alive = now
            self.emit("alive", child_pid=child_pid)

    def fault(self, reason: str, action: str) -> None:
        self.emit("fault", severity="warning", reason=reason,
                  action=action)

    def join(self, round_no: int) -> None:
        self.emit("join", round=int(round_no), rows=self.rows)

    def ack(self, round_no: int, ok: bool,
            mean_drift: float | None = None, out_rank: int | None = None,
            out_rows: int | None = None) -> None:
        self.emit("ack", round=int(round_no), ok=bool(ok),
                  mean_drift=mean_drift, out_rank=out_rank,
                  out_rows=out_rows)

    def done(self, rc: int) -> None:
        self.emit("done", rc=int(rc))

    def poll(self) -> list[dict]:
        """Newly broadcast coordinator events (call/assign/go/...)."""
        return [ev for ev in self.tailer.poll()
                if ev.get("kind") in ("rendezvous", "fleet")]


# -- coordinator -------------------------------------------------------------


class Coordinator:
    """Pod coordinator: watch every host's supervisor stream, and on a
    host fault or host silence run ONE rendezvous → assign → ack → go
    cycle for the whole fleet.  ``hosts`` maps host id → rank rows that
    host owns (the slice size); the world is their sum."""

    def __init__(self, fleet_dir: str, hosts: dict[int, int],
                 checkpoint_dir: str | None = None, tag: str = "", *,
                 gossip: bool = True, algorithm: str = "sgp",
                 gap_floor: float = 0.01, overlap: bool = False,
                 faults: bool = False,
                 deadline_s: float = 10.0,
                 host_timeout_s: float = 15.0,
                 hello_grace_s: float = 120.0,
                 ack_timeout_s: float = 300.0,
                 poll_interval_s: float = 0.25,
                 max_cycles: int = 3, min_hosts: int = 1,
                 install_signal_handlers: bool = True,
                 on_cycle=None, log=None):
        if not hosts:
            raise ValueError("a fleet needs at least one host")
        for h, rows in hosts.items():
            if rows < 1:
                raise ValueError(f"host {h} must own >= 1 rank rows, "
                                 f"got {rows}")
        self.fleet_dir = fleet_dir
        self.checkpoint_dir = checkpoint_dir or fleet_dir
        self.tag = tag
        self.gossip = gossip
        self.algorithm = algorithm
        self.gap_floor = gap_floor
        self.overlap = overlap
        self.faults = faults
        self.deadline_s = float(deadline_s)
        self.host_timeout_s = float(host_timeout_s)
        self.hello_grace_s = float(hello_grace_s)
        self.ack_timeout_s = float(ack_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.max_cycles = int(max_cycles)
        self.min_hosts = max(1, int(min_hosts))
        self.on_cycle = on_cycle  # hook(assign_event_data) — selftest
        self._install_handlers = install_signal_handlers
        self.log = log or make_logger("coordinator")

        self.live: dict[int, int] = {int(h): int(r)
                                     for h, r in hosts.items()}
        self.world = sum(self.live.values())
        self.generation = 0
        self.cycle = 0        # completed assign→go cycles
        self._round = 0       # monotone rendezvous round counter
        self.done: set[int] = set()
        self.excluded: list[int] = []
        # grow-the-world: hosts that said hello but are not yet members.
        # A hello from an unknown host id is a join request; it becomes
        # a coordinated grow cycle (upward reshard n -> n') exactly like
        # a fault becomes a shrink cycle.
        self._joining: dict[int, int] = {}
        self.child_pids: dict[int, int] = {}
        self._last_seen: dict[int, float | None] = {
            h: None for h in self.live}
        self._faulted: dict[int, str] = {}
        self._preempted = False
        self._start_t = time.time()
        self._last_assign: dict = {}
        self._last_acks: dict[int, float | None] = {}

        os.makedirs(fleet_dir, exist_ok=True)
        self.registry = TelemetryRegistry(rank=0, sinks=[
            JsonlSink(os.path.join(fleet_dir, COORDINATOR_EVENTS_FILE)),
            LoggerCompatSink(self.log)])
        self._tailers = {
            h: EventTailer(os.path.join(host_dir(fleet_dir, h),
                                        SUPERVISOR_EVENTS_FILE))
            for h in self.live}

    # -- signals -----------------------------------------------------------

    def _on_signal(self, signum, frame):
        self.log.warning("coordinator received %s; halting the fleet",
                         signal.Signals(signum).name)
        self._preempted = True

    # -- event intake ------------------------------------------------------

    def _scan_new_hosts(self) -> None:
        """Attach tailers for host directories that appeared after
        startup — the transport half of grow-the-world.  A joining
        host's supervisor creates ``host{h}/supervisor.jsonl`` before it
        says hello; without this scan the hello would never be read."""
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            return
        for name in names:
            if not (name.startswith("host") and name[4:].isdigit()):
                continue
            h = int(name[4:])
            if h not in self._tailers:
                self._tailers[h] = EventTailer(os.path.join(
                    host_dir(self.fleet_dir, h), SUPERVISOR_EVENTS_FILE))

    def _poll_hosts(self) -> list[dict]:
        """Drain every host stream once: update liveness/fault/done
        bookkeeping, and return the raw ``rendezvous`` events so the
        phase loops (join/ack collection) can scan them too."""
        self._scan_new_hosts()
        out: list[dict] = []
        now = time.time()
        for h, tailer in self._tailers.items():
            for ev in tailer.poll():
                self._last_seen[h] = now
                if ev.get("kind") != "rendezvous":
                    continue
                data = ev.get("data") or {}
                phase = data.get("phase")
                if phase in ("hello", "alive"):
                    pid = data.get("child_pid")
                    if pid is not None:
                        self.child_pids[h] = int(pid)
                    if (phase == "hello" and h not in self.live
                            and h not in self.done):
                        rows = int(data.get("rows") or 1)
                        if self._joining.get(h) != rows:
                            self._joining[h] = rows
                            self.log.warning(
                                "host %d asks to join with %d row(s)",
                                h, rows)
                elif phase == "fault" and h in self.live \
                        and h not in self._faulted:
                    self._faulted[h] = (f"host {h}: "
                                        f"{data.get('reason', '?')}")
                elif phase == "done":
                    self.done.add(h)
                out.append({"host": h, **data})
        return out

    def _silent_host(self) -> tuple[int, float] | None:
        """The first live, not-done host past its liveness grace, if
        any.  A host that never said hello gets the longer startup
        grace (its supervisor may still be compiling/launching)."""
        now = time.time()
        for h in sorted(self.live):
            if h in self.done:
                continue
            seen = self._last_seen.get(h)
            grace = (self.host_timeout_s if seen is not None
                     else self.hello_grace_s)
            ref = seen if seen is not None else self._start_t
            if now - ref > grace:
                return h, now - ref
        return None

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> int:
        old_handlers = {}
        if self._install_handlers:
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                old_handlers[sig] = signal.signal(sig, self._on_signal)
        try:
            return self._run()
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.registry.close()

    def _run(self) -> int:
        self._start_t = time.time()   # liveness grace counts from here
        self.registry.emit("fleet", {
            "phase": "start", "world": self.world,
            "hosts": {str(h): r for h, r in sorted(self.live.items())}})
        while True:
            self._poll_hosts()
            if self._preempted:
                self.registry.emit("fleet", {
                    "phase": "halt",
                    "reason": "coordinator preempted"},
                    severity="warning")
                return REQUEUE_EXIT_CODE
            if self.done >= set(self.live):
                self.registry.emit("fleet", {
                    "phase": "complete", "world": self.world,
                    "generation": self.generation,
                    "cycles": self.cycle})
                self.log.info("fleet complete: world %d, generation %d, "
                              "%d coordinated cycle(s)", self.world,
                              self.generation, self.cycle)
                return 0
            cause = None
            if self._faulted:
                cause = "host-fault: " + "; ".join(
                    self._faulted[h] for h in sorted(self._faulted))
            else:
                silent = self._silent_host()
                if silent is not None:
                    cause = (f"host-silence: host {silent[0]} quiet for "
                             f"{silent[1]:.0f}s")
                elif self._joining:
                    cause = "host-join: " + "; ".join(
                        f"host {h} (+{r} rows)"
                        for h, r in sorted(self._joining.items()))
            if cause is not None:
                rc = self._cycle(cause)
                if rc is not None:
                    return rc
            time.sleep(self.poll_interval_s)

    # -- the coordinated relaunch cycle ------------------------------------

    def _give_up(self, reason: str) -> int:
        self.registry.emit("fleet", {"phase": "give-up",
                                     "reason": reason},
                           severity="error")
        self.log.error("fleet give-up: %s", reason)
        return 1

    def _cycle(self, cause: str) -> int | None:
        """One coordinated rendezvous → assign → ack → go cycle.
        Returns an exit code to propagate, or None to keep watching."""
        if self.cycle >= self.max_cycles:
            return self._give_up(
                f"{cause}, but the coordinated-cycle budget "
                f"({self.max_cycles}) is spent")
        self.log.warning("fleet cycle %d: %s", self.cycle + 1, cause)
        # joiners rendezvous alongside the incumbents: the barrier is
        # how the whole fleet agrees on the grown world before any
        # upward reshard happens
        expected = ({h for h in self.live if h not in self.done}
                    | set(self._joining))
        # every membership change re-runs the barrier; bound the total
        # rounds so a flapping fleet degrades to give-up, never a hang
        max_rounds = 2 * len(expected) + 2
        rounds = 0
        while True:
            joined = self._rendezvous(expected, cause)
            rounds += 1
            if joined is None:      # every expected host missed
                return self._give_up(
                    f"{cause}: no host joined the rendezvous")
            if set(joined) != expected:
                # deadline-missed hosts are out of the world; RE-RUN the
                # barrier at the smaller membership so the survivors
                # re-confirm against the world they will actually share
                missed = sorted(expected - set(joined))
                self.log.warning(
                    "rendezvous round %d: host(s) %s missed the "
                    "deadline; excluded — re-running at %d host(s)",
                    self._round, missed, len(joined))
                for h in missed:
                    self.live.pop(h, None)
                    self._joining.pop(h, None)
                    self.excluded.append(h)
                expected = set(joined)
                if len(expected) < self.min_hosts:
                    return self._give_up(
                        f"{cause}: only {len(expected)} host(s) "
                        f"rendezvoused (min_hosts {self.min_hosts})")
                if rounds >= max_rounds:
                    return self._give_up(
                        f"{cause}: membership still changing after "
                        f"{rounds} rendezvous rounds")
                continue
            acked = self._assign_and_collect_acks(joined, cause)
            if set(acked) == set(joined):
                break
            missed = sorted(set(joined) - set(acked))
            self.log.warning(
                "cycle: host(s) %s never acked their shard; excluded — "
                "re-running the rendezvous", missed)
            for h in missed:
                self.live.pop(h, None)
                self._joining.pop(h, None)
                self.excluded.append(h)
            expected = {h for h in expected if h not in missed}
            if len(expected) < self.min_hosts:
                return self._give_up(
                    f"{cause}: only {len(expected)} host(s) acked "
                    f"(min_hosts {self.min_hosts})")
            if rounds >= max_rounds:
                return self._give_up(
                    f"{cause}: membership still changing after "
                    f"{rounds} rendezvous rounds")
        # commit: every survivor resharded its shard — relaunch together
        self.cycle += 1
        self.generation += 1
        prev_world = self.world
        self.world = sum(joined.values())
        self.live = dict(joined)
        if self.on_cycle is not None:
            self.on_cycle(dict(self._last_assign))
        self.registry.emit("fleet", {
            "phase": "go", "round": self._round, "cycle": self.cycle,
            "world": self.world, "prev_world": prev_world,
            "generation": self.generation,
            "acks": {str(h): self._last_acks.get(h)
                     for h in sorted(joined)}},
            severity="warning")
        self.log.warning(
            "fleet cycle %d committed: world %d -> %d over %d host(s), "
            "excluded %s", self.cycle, prev_world, self.world,
            len(joined), self.excluded)
        # fresh generation: clear fault flags and give every survivor a
        # fresh liveness clock (its child recompiles from scratch).
        # Joiners that made this generation are members now; one that
        # hello'd mid-cycle stays queued and triggers the next cycle.
        self._faulted.clear()
        self._joining = {h: r for h, r in self._joining.items()
                         if h not in self.live}
        now = time.time()
        for h in self.live:
            self._last_seen[h] = now
        return None

    def _warn_tag_mismatch(self) -> None:
        """No stamped plan under our tag — if checkpoint files exist
        under a DIFFERENT tag (an LM fleet writes ``lm_…`` while the
        coordinator defaulted to ``""``), the replan silently loses the
        stamped wire/fabric/synth constraints and can assign a plan the
        children reject at launch.  The coordinator and the per-host
        supervisors are launched separately, so this cannot be
        validated at startup; flag it loudly at replan time instead."""
        import re

        pat = re.compile(r"checkpoint_r\d+_n\d+\.ckpt$")
        try:
            names = os.listdir(self.checkpoint_dir)
        except OSError:
            return
        ours = re.compile(
            r"^" + re.escape(self.tag) + r"checkpoint_r\d+_n\d+\.ckpt$")
        foreign = sorted(n for n in names
                         if pat.search(n) and not ours.match(n))
        if foreign:
            self.log.error(
                "no stamped plan under tag %r, but checkpoint files "
                "exist under other tags (%s) — the coordinator's "
                "--tag/--checkpoint_dir must match the children's, or "
                "replans lose the stamped wire/fabric constraints",
                self.tag, ", ".join(foreign[:4]))

    def _rendezvous(self, expected: set[int],
                    cause: str) -> dict[int, int] | None:
        """One barrier round: call, then collect joins until every
        expected host answered or the deadline passes.  Returns
        ``{host: rows}`` for the joiners (possibly a subset), or None
        when nobody joined."""
        self._round += 1
        self.registry.emit("rendezvous", {
            "phase": "call", "round": self._round, "cause": cause,
            "deadline_s": self.deadline_s,
            "hosts": sorted(expected)}, severity="warning")
        deadline = time.time() + self.deadline_s
        joined: dict[int, int] = {}
        while time.time() < deadline and set(joined) != expected:
            for msg in self._poll_hosts():
                if (msg.get("phase") == "join"
                        and msg.get("round") == self._round
                        and msg["host"] in expected):
                    h = msg["host"]
                    joined[h] = int(
                        msg.get("rows") or self.live.get(h)
                        or self._joining.get(h, 1))
            time.sleep(self.poll_interval_s)
        return joined or None

    def _assign_and_collect_acks(self, joined: dict[int, int],
                                 cause: str) -> dict[int, float | None]:
        """Broadcast the shard assignment for the agreed world, then
        collect per-host reshard acks until the ack deadline."""
        survivors = sorted(joined)
        new_world = sum(joined.values())
        shards, offset = {}, 0
        for i, h in enumerate(survivors):
            shards[str(h)] = {"out_rank": i, "out_rows": joined[h],
                              "host_index": i,
                              "num_hosts": len(survivors),
                              "rank_offset": offset}
            offset += joined[h]
        # re-plan ONCE for the fleet, under the stamped constraints —
        # per-host supervisors receive the plan in this broadcast
        # instead of each re-deriving (and possibly disagreeing on) it
        stamped = stamped_plan(self.checkpoint_dir, self.tag)
        if stamped is None and self.gossip:
            self._warn_tag_mismatch()
        plan = replan_for(
            new_world, stamped,
            gossip=self.gossip, algorithm=self.algorithm,
            gap_floor=self.gap_floor, overlap=self.overlap,
            faults=self.faults, log=self.log)
        assign = {
            "phase": "assign", "round": self._round,
            "cycle": self.cycle + 1, "cause": cause,
            "world": new_world, "prev_world": self.world,
            "plan": plan, "shards": shards,
            "excluded": sorted(self.excluded)}
        self._last_assign = assign
        self.registry.emit("fleet", assign, severity="warning")
        deadline = time.time() + self.ack_timeout_s
        acks: dict[int, float | None] = {}
        self._last_acks = acks
        while time.time() < deadline and set(acks) != set(joined):
            for msg in self._poll_hosts():
                if (msg.get("phase") == "ack"
                        and msg.get("round") == self._round
                        and msg["host"] in joined):
                    acks[msg["host"]] = msg.get("mean_drift")
                    if not msg.get("ok", False):
                        self.log.warning(
                            "host %d acked without a reshard (torn or "
                            "missing source set); it relaunches cold",
                            msg["host"])
            time.sleep(self.poll_interval_s)
        return acks
