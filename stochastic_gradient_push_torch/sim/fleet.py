"""The fleet lane: REAL coordinator, simulated hosts.

Port of ``stochastic_gradient_push_tpu/sim/fleet.py``.  A pod farm is
8–64 hosts owning 1024–4096 ranks, and nothing at that scale fits in
subprocesses on a test box.  :class:`SimHost` is a thread that speaks
the exact host-side protocol (:class:`~..supervise.coordinator.
FleetMember` events into ``host{h}/supervisor.jsonl``, the port's
reshardable rank files, the join barrier, a concurrent
``reshard_checkpoints`` of its assigned shard) against the *unmodified*
:class:`~..supervise.coordinator.Coordinator`.  Only the trainer is
simulated; the rendezvous, exclusion, replan, assignment and commit
logic that runs here is the production code.

**Saves.**  The reference writes one msgpack file a host and saves at
every drain ("the save IS the shard boundary"), so a killed host's file
stays at an older step than the survivors' and the reshard mixes them.
The port writes one ``torch.save`` file a rank, and its loader refuses a
set whose files come from different saves.  So a host saves through
:class:`~..supervise.hostsim.HostFiles`, the world's save barrier, and
keeps its rule: the hosts of a world stage a save together and commit it
once all have staged; a host of several does not save on a drain, and
its boundary is the world's last committed save (a host alone saves at
the drain's step, as the reference's).  No supervisor drains a thread
here, so a host saving or waiting at the barrier on a dead peer leaves
the save when the coordinator's ``rendezvous`` ``call`` (or a terminal
decision) arrives, as a drained child would.  Its files skip fsync: a
thread's kill loses nothing written.  The per-host supervisor's
liveness heartbeat runs beside its trainer (a thread, as the real
supervisor's runs beside its child), so a host busy writing its 128
rank files is not taken for a silent one; a killed host's heartbeat
dies with it.

What changes against the reference is the boundary: the killed host's
peers restart from the last save the whole world committed, where the
reference's restart from their own drain saves.  ``FleetReport``'s
``rc``, ``world``, ``prev_world``, ``cycles`` and ``excluded`` are the
reference's for the same campaign; the boundary's step
(:attr:`FleetReport.boundary_step`, port only) and its drift are not.

Scenarios (:func:`run_sim_fleet`):

* **whole-slice kill** — a victim host stops emitting mid-run (the
  SIGKILL shape); the coordinator must detect silence, exclude it, and
  drive exactly ONE coordinated shrink cycle;
* **coordinator loss** — the coordinator starts ``down_s`` seconds
  late: the host events queue in the stream files (tailers replay), and
  recovery still produces exactly one cycle;
* **grow-the-world** — a joiner host appears mid-run: its hello is a
  join request, and the coordinator runs one n → n′ *upward* reshard
  cycle in which every host — incumbent and joiner alike — restarts
  from consensus-collapsed rows of the grown world (the exact network
  mean, so the boundary drift is f32 cast error only).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np

from ..supervise.coordinator import Coordinator, FleetMember, host_dir
from ..supervise.hostsim import HostFiles
from ..supervise.reshard import (TornCheckpointError, consensus_mean,
                                 load_world_checkpoint,
                                 reshard_checkpoints)
from ..telemetry import (COORDINATOR_EVENTS_FILE, JsonlSink,
                         SUPERVISOR_EVENTS_FILE, TelemetryRegistry)

__all__ = ["SimHost", "FleetReport", "run_sim_fleet"]

PARAM_DIM = 16  # matches supervise/hostsim.py

# the simulated hosts are threads of one interpreter: one reshard at a
# time, so seven hosts' file reads do not convoy on the interpreter lock
# (the coordinator waits for every ack, in any order)
_RESHARD_LOCK = threading.Lock()


def _wakes(ev: dict) -> bool:
    """A coordinator event that ends a wait at the save barrier: a
    rendezvous call, or a decision that ends the fleet."""
    phase = (ev.get("data") or {}).get("phase")
    return ((ev.get("kind") == "rendezvous" and phase == "call")
            or (ev.get("kind") == "fleet"
                and phase in ("halt", "give-up", "complete")))


class SimHost(threading.Thread):
    """One simulated host: ``rows`` ranks of the gossip world, the full
    member side of the coordination protocol, none of the accelerator.

    ``process_id`` / ``num_processes``: this host's place among the
    world's hosts, for the save barrier (default: host id among
    ``num_processes`` hosts).  ``join=True`` makes it a late joiner: it
    pre-drains the broadcast tailer (which replays from byte 0), says
    hello as its join request, and only starts training after the
    coordinator's go hands it a consensus-initialized shard of the grown
    world."""

    def __init__(self, fleet_dir: str, host: int, rows: int,
                 rank_offset: int, world: int, *,
                 process_id: int | None = None, num_processes: int = 1,
                 checkpoint_dir: str | None = None, tag: str = "",
                 steps: int = 20, save_every: int = 5,
                 step_s: float = 0.005, seed: int = 0,
                 alive_interval_s: float = 0.3,
                 poll_s: float = 0.05, join: bool = False):
        super().__init__(name=f"simhost{host}", daemon=True)
        self.fleet_dir = fleet_dir
        self.checkpoint_dir = checkpoint_dir or fleet_dir
        self.tag = tag
        self.host = int(host)
        self.rows = int(rows)
        self.rank_offset = int(rank_offset)
        self.world = int(world)
        self.process_id = int(host if process_id is None else process_id)
        self.num_processes = int(num_processes)
        self.steps = int(steps)
        self.save_every = int(save_every)
        self.step_s = float(step_s)
        self.seed = int(seed)
        self.poll_s = float(poll_s)
        self.joiner = bool(join)
        self.out_rank = int(host)
        self.step = 0
        self.committed = -1       # step of the world's last committed save
        self.boundary_step: int | None = None
        self.plan = None
        self.generation = 0
        self.relaunches = 0
        self.exit_reason: str | None = None
        self.kill_event = threading.Event()   # whole-slice SIGKILL
        self._ended = threading.Event()
        self._pending: list[dict] = []
        self._polled = 0.0
        self.files: HostFiles | None = None
        os.makedirs(host_dir(fleet_dir, host), exist_ok=True)
        self._registry = TelemetryRegistry(rank=host, sinks=[
            JsonlSink(os.path.join(host_dir(fleet_dir, host),
                                   SUPERVISOR_EVENTS_FILE))])
        self.member = FleetMember(fleet_dir, host, rows,
                                  alive_interval_s=alive_interval_s)
        self.member.bind(self._registry)
        self._state: dict | None = None

    # -- trainer ----------------------------------------------------------

    def _init_state(self) -> dict:
        w = np.stack([
            np.random.default_rng(
                self.seed * 100_003 + self.rank_offset + i)
            .standard_normal(PARAM_DIM).astype(np.float32)
            for i in range(self.rows)])
        return {"params": {"w": w},
                "gossip": {"ps_weight": np.ones(self.rows, np.float32),
                           "phase": np.zeros(self.rows, np.int32)}}

    def _open_files(self) -> HostFiles:
        """This generation's rank files and save barrier (its poll at
        this host's own pace)."""
        self.files = HostFiles(self.checkpoint_dir, self.tag, self.world,
                               self.num_processes, self.process_id,
                               self.rank_offset, self.rows, fsync=False,
                               poll_s=self.poll_s)
        return self.files

    def _begin(self, committed: int) -> None:
        """This generation's barrier starts at ``committed`` (the step it
        resumes from; -1 before any save)."""
        self.files.mark(staged=committed, committed=committed)
        self.committed = committed

    def checkpointed(self) -> bool:
        """Every rank file of this host's rows is on disk."""
        return self.files is not None and all(
            os.path.isfile(self.files.path(r)) for r in self.files.ranks)

    def _meta(self) -> dict:
        meta = {"step": self.step, "world": self.world, "rows": self.rows,
                "process_id": self.process_id,
                "num_processes": self.num_processes, "epoch": 0,
                "itr": self.step}
        if self.plan is not None:
            meta["plan"] = self.plan
        return meta

    def _interrupted(self) -> bool:
        """The save's drain test: killed, or a coordinator event that
        ends the save has arrived (kept for the main loop).  The
        broadcast stream is read at most every ``poll_s``."""
        if self.kill_event.is_set():
            return True
        now = time.monotonic()
        if now - self._polled >= self.poll_s:
            self._polled = now
            self._pending.extend(self.member.poll())
        return any(_wakes(ev) for ev in self._pending)

    def _save(self) -> bool:
        """One save of the world at this step; False when the barrier
        was left before the commit."""
        if not self.files.save(self._state, self._meta(), self.committed,
                               self._interrupted):
            return False
        self.committed = self.step
        return True

    def _train_step(self) -> None:
        rng = np.random.default_rng(
            self.seed * 100_003 + (self.rank_offset << 20) + self.step)
        w = self._state["params"]["w"]
        self._state["params"]["w"] = (
            w + 0.01 * rng.standard_normal(w.shape).astype(w.dtype))
        self.step += 1

    # -- protocol ---------------------------------------------------------

    def _reshard_and_ack(self, data: dict, shard: dict) -> None:
        """Write this host's rank files of the new world: ranks
        ``rank_offset .. rank_offset + out_rows - 1``."""
        lo = int(shard["rank_offset"])
        report = None
        try:
            with _RESHARD_LOCK:
                report = reshard_checkpoints(
                    self.checkpoint_dir, self.tag, data["prev_world"],
                    data["world"],
                    ranks=range(lo, lo + int(shard["out_rows"])),
                    plan=data.get("plan"))
        except (TornCheckpointError, ValueError):
            pass
        self.member.ack(data["round"], ok=report is not None,
                        mean_drift=(report.mean_drift
                                    if report is not None else None),
                        out_rank=shard["out_rank"],
                        out_rows=shard["out_rows"])

    def _adopt(self, data: dict, shard: dict) -> None:
        """Coordinator committed: reload the consensus-initialized
        shard of the new world and keep training."""
        self.world = int(data["world"])
        self.out_rank = int(shard["out_rank"])
        self.rows = int(shard["out_rows"])
        self.rank_offset = int(shard["rank_offset"])
        self.process_id = int(shard["out_rank"])
        self.num_processes = int(shard["num_hosts"])
        self.generation += 1
        self.relaunches += 1
        self._state, meta = self._open_files().load()
        self.step = int(meta.get("step", self.step))
        self.plan = meta.get("plan")
        self.boundary_step = self.step
        self._begin(self.step)

    def _rendezvous_wait(self, backlog: list[dict]) -> bool:
        """Answer a rendezvous (``backlog``: events already read, the
        call among them); block until go/excluded/terminal.  Returns
        False when the host should exit."""
        assign = shard = None
        events = list(backlog)
        while not self.kill_event.is_set():
            events += self.member.poll()
            for ev in events:
                data = ev.get("data") or {}
                phase = data.get("phase")
                if ev.get("kind") == "rendezvous" and phase == "call":
                    assign = shard = None
                    self.member.join(data["round"])
                elif ev.get("kind") == "fleet" and phase == "assign":
                    mine = (data.get("shards") or {}).get(str(self.host))
                    if mine is not None:
                        assign, shard = data, mine
                        self._reshard_and_ack(data, mine)
                    elif self.host in (data.get("excluded") or []):
                        self.exit_reason = "excluded"
                        return False
                elif (ev.get("kind") == "fleet" and phase == "go"
                        and assign is not None
                        and data.get("round") == assign.get("round")):
                    self._adopt(assign, shard)
                    return True
                elif ev.get("kind") == "fleet" and phase in (
                        "halt", "give-up", "complete"):
                    self.exit_reason = f"coordinator {phase}"
                    return False
            events = []
            time.sleep(self.poll_s)
        return False

    def _handle_events(self) -> bool:
        """Act on the coordinator's events since the last look; False
        when the host should exit."""
        events, self._pending = (self._pending + self.member.poll(), [])
        for i, ev in enumerate(events):
            data = ev.get("data") or {}
            if ev.get("kind") == "rendezvous" \
                    and data.get("phase") == "call":
                if self.num_processes == 1 and self.committed < self.step:
                    # a host alone saves at the drain (no peer to mix
                    # with); a host of several keeps the world's last
                    # committed save as its boundary
                    self._save()
                return self._rendezvous_wait(events[i:])
            if ev.get("kind") == "fleet" and data.get("phase") == "halt":
                self.exit_reason = "halt"
                return False
        return True

    def _heartbeat(self) -> None:
        """The per-host supervisor's liveness, beside its trainer."""
        while not self._ended.wait(self.poll_s):
            if self.kill_event.is_set():
                return
            self.member.maybe_alive(os.getpid())

    def run(self) -> None:  # pragma: no branch - thread entry
        beat = threading.Thread(target=self._heartbeat,
                                name=f"{self.name}-alive", daemon=True)
        try:
            self._run(beat)
        finally:
            self._ended.set()
            if beat.is_alive():
                beat.join()
            self._registry.close()

    def _run(self, beat: threading.Thread) -> None:
        if self.joiner:
            # the broadcast tailer replays history; a joiner must only
            # act on its own grow cycle
            self.member.poll()
            self.member.hello(world=self.world, generation=0,
                              child_pid=os.getpid())
            beat.start()
            if not self._rendezvous_wait([]):
                return
        else:
            self._state = self._init_state()
            self._open_files()
            self._begin(-1)
            self.member.hello(world=self.world, generation=0,
                              child_pid=os.getpid())
            beat.start()
            self._save()
            if not self._handle_events():
                return
        while True:
            if self.kill_event.is_set():
                return            # whole-slice SIGKILL: vanish silently
            if self.step >= self.steps and self.committed >= self.step:
                break
            if self.step < self.steps:
                self._train_step()
            if (self.step % self.save_every == 0
                    or self.step >= self.steps) \
                    and self.committed < self.step:
                self._save()
            if not self._handle_events():
                return
            if self.step < self.steps:
                time.sleep(self.step_s)
        self.member.done(0)
        self.exit_reason = "complete"


# -- scenario driver ---------------------------------------------------------


@dataclasses.dataclass
class FleetReport:
    """What one simulated-fleet scenario did, for assertions.
    ``boundary_step`` (port only): the step of the set the committed
    cycle resharded, the world's last committed save."""

    rc: int
    prev_world: int
    world: int
    cycles: int
    calls: int
    assigns: int
    gos: int
    excluded: list[int]
    drift: float | None        # |consensus mean| change at the boundary
    ps_weight_reset: bool | None
    host_exit: dict[int, str | None]
    host_relaunches: dict[int, int]
    boundary_step: int | None = None

    def summary(self) -> str:
        return (f"world {self.prev_world} -> {self.world}, "
                f"{self.cycles} cycle(s), {self.calls} call(s), "
                f"{self.assigns} assign(s), {self.gos} go(s), "
                f"excluded {self.excluded}, drift "
                f"{'-' if self.drift is None else f'{self.drift:.2e}'}")


def _coord_events(fleet_dir: str) -> list[dict]:
    path = os.path.join(fleet_dir, COORDINATOR_EVENTS_FILE)
    out = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def run_sim_fleet(fleet_dir: str, hosts: dict[int, int], *,
                  steps: int = 20, save_every: int = 5,
                  step_s: float = 0.005, seed: int = 0,
                  campaign=None, join_rows: int | None = None,
                  gossip: bool = False, gap_floor: float = 0.01,
                  deadline_s: float = 2.0, host_timeout_s: float = 1.5,
                  ack_timeout_s: float = 60.0, max_cycles: int = 2,
                  timeout_s: float = 120.0) -> FleetReport:
    """One fleet scenario end to end against the real coordinator.

    ``hosts`` maps host id → rows; ``campaign`` (a
    :class:`~.campaign.Campaign`) contributes ``kill_hosts`` (negative
    ids index from the end) and ``coordinator_down_s``; ``join_rows``
    adds one joiner host (id ``max+1``) once the initial fleet has
    checkpointed, exercising the grow-the-world induction.
    """
    os.makedirs(fleet_dir, exist_ok=True)
    world = sum(hosts.values())
    offsets, off = {}, 0
    for h in sorted(hosts):
        offsets[h] = off
        off += hosts[h]
    sims = {h: SimHost(fleet_dir, h, hosts[h], offsets[h], world,
                       process_id=i, num_processes=len(hosts),
                       steps=steps, save_every=save_every,
                       step_s=step_s, seed=seed)
            for i, h in enumerate(sorted(hosts))}
    for s in sims.values():
        s.start()

    def all_checkpointed() -> bool:
        return all(s.checkpointed() for s in sims.values())

    kill_hosts: list[int] = []
    if campaign is not None:
        order = sorted(hosts)
        kill_hosts = [order[h] for h in campaign.kill_hosts]
    joiner: SimHost | None = None

    def chaos() -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline and not all_checkpointed():
            time.sleep(0.05)
        for h in kill_hosts:
            sims[h].kill_event.set()
        nonlocal joiner
        if join_rows is not None:
            jid = max(hosts) + 1
            joiner = SimHost(fleet_dir, jid, join_rows, 0, world,
                             steps=steps, save_every=save_every,
                             step_s=step_s, seed=seed, join=True)
            joiner.start()

    chaos_thread = threading.Thread(target=chaos, daemon=True)
    chaos_thread.start()

    boundary: dict = {}

    def on_cycle(assign: dict) -> None:
        try:
            old, _, _ = load_world_checkpoint(
                fleet_dir, "", assign["prev_world"])
            new, meta, _ = load_world_checkpoint(
                fleet_dir, "", assign["world"])
            m_old, m_new = consensus_mean(old), consensus_mean(new)
            boundary["drift"] = max(
                float(np.abs(m_old[k] - m_new[k]).max()) for k in m_old)
            boundary["ps_reset"] = bool(np.all(
                np.asarray(new["gossip"]["ps_weight"]) == 1.0))
            boundary["step"] = meta.get("step")
        except Exception as e:  # noqa: BLE001 — the report carries it
            # the scenario's report carries any boundary-load failure as
            # data
            boundary["error"] = repr(e)

    if campaign is not None and campaign.coordinator_down_s:
        # coordinator loss: it comes up late; the stream files queued
        # everything and the tailers replay, so nothing is lost
        time.sleep(campaign.coordinator_down_s)
    coord = Coordinator(
        fleet_dir, dict(hosts), checkpoint_dir=fleet_dir, tag="",
        gossip=gossip, gap_floor=gap_floor,
        deadline_s=deadline_s, host_timeout_s=host_timeout_s,
        hello_grace_s=30.0, ack_timeout_s=ack_timeout_s,
        poll_interval_s=0.05, max_cycles=max_cycles, min_hosts=1,
        install_signal_handlers=False, on_cycle=on_cycle)
    rc = coord.run()
    chaos_thread.join(timeout=5)
    for s in list(sims.values()) + ([joiner] if joiner else []):
        if rc != 0:
            s.kill_event.set()
        s.join(timeout=30)

    evs = _coord_events(fleet_dir)
    calls = [e for e in evs if e.get("kind") == "rendezvous"
             and e["data"].get("phase") == "call"]
    assigns = [e for e in evs if e.get("kind") == "fleet"
               and e["data"].get("phase") == "assign"]
    gos = [e for e in evs if e.get("kind") == "fleet"
           and e["data"].get("phase") == "go"]
    everyone = dict(sims)
    if joiner is not None:
        everyone[joiner.host] = joiner
    return FleetReport(
        rc=rc, prev_world=world, world=coord.world, cycles=coord.cycle,
        calls=len(calls), assigns=len(assigns), gos=len(gos),
        excluded=sorted(coord.excluded),
        drift=boundary.get("drift"),
        ps_weight_reset=boundary.get("ps_reset"),
        host_exit={h: s.exit_reason for h, s in everyone.items()},
        host_relaunches={h: s.relaunches for h, s in everyone.items()},
        boundary_step=boundary.get("step"))
