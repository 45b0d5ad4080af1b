"""The run supervisor: launch, watch, drain, reshard, replan, relaunch.

Port of ``stochastic_gradient_push_tpu/supervise/supervisor.py`` over
the port's CLIs (``python -m stochastic_gradient_push_torch.run.
gossip_sgd`` / ``.gossip_lm``) and its one-file-a-rank checkpoints.
One :class:`Supervisor` owns one training run across its generations.
Per generation it launches the training CLI as a managed child process,
tails ``<trace_dir>/events.jsonl`` (the typed registry stream: health
excursions, recovery events carrying ``suggestion.switch``, watchdog
stalls, step_stats heartbeats) and feeds the
:class:`~.policy.SupervisorPolicy`.  When the policy decides, the
supervisor runs the relaunch cycle:

1. **drain** — SIGUSR1 to the child; the run-layer signal path finishes
   the in-flight chunk, checkpoints, and exits ``REQUEUE_EXIT_CODE``
   (the checkpoint barrier: that exit code is only reachable *after*
   the save landed).  A wedged child (dead collective) is SIGKILLed
   after ``drain_timeout_s`` — its last epoch-boundary checkpoint is
   the restart point;
2. **reshard** — :func:`~.reshard.reshard_checkpoints` collapses the
   per-rank checkpoints to the exact consensus and re-stacks them at
   the surviving world size (also run for same-world relaunches: the
   restart boundary is an exact global average, the planner's own
   below-floor fallback); a set whose rank files come from different
   saves is torn, and the relaunch goes cold;
3. **replan** — ``planner.plan_for`` for the new world under the run's
   stamped :class:`~..planner.PlanConstraints` (fabric model, fault
   injection, algorithm — read back from the checkpoint metadata the
   launch stamped);
4. **relaunch** — the child argv is rewritten with the new
   ``--world_size/--topology/--slice_size/--global_avg_every/
   --mixing_alpha`` flags and ``--resume True``.

The supervisor's own decisions stream to
``<trace_dir>/supervisor.jsonl`` as typed ``supervisor``/``relaunch``
events (same envelope as the child's registry; a separate file so the
tailer never reads back its own writes), the reference's kinds and
fields.

A preemption signal (SIGTERM/SIGUSR1) to the *supervisor* drains the
child and exits with ``REQUEUE_EXIT_CODE`` itself, so an outer
scheduler can requeue the whole job.

**Fleet mode** (``fleet=FleetMember(...)``): the supervisor is one host
of a pod and relaunch decisions belong to the pod-level
:class:`~.coordinator.Coordinator`.  Detection stays local — the same
policy watches the same child stream — but instead of resharding and
relaunching on its own, the supervisor reports the fault, answers the
coordinator's rendezvous calls (draining or burying its child first),
reshards exactly the shard the assignment names — the rank files
``rank_offset .. rank_offset + out_rows - 1`` (concurrently with every
other survivor) — acks, and relaunches
only on the coordinator's ``go`` — so a pod-wide failure produces one
coordinated cycle, never a per-host relaunch storm.  Between relaunch
cycles it heartbeats ``rendezvous alive`` events (with the child pid)
so the coordinator can tell a dead host from a quiet one.

The selftest's chaos kill waits for a whole set: where the reference's
trigger is rank 0's file (one file holding every row), here it is every
rank file of the generation's world, landed after launch.  The child is
stopped (SIGSTOP) before the files' save points are compared, so the
SIGKILL never lands between two ranks' renames; a set caught mid-save
lets the child go on (SIGCONT) until the next poll.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import time

from ..telemetry import (
    EVENTS_FILE,
    JsonlSink,
    LoggerCompatSink,
    SUPERVISOR_EVENTS_FILE,
    TelemetryRegistry,
)
from ..utils.checkpoint import REQUEUE_EXIT_CODE
from ..utils.logging import make_logger
from .coordinator import EXCLUDED_EXIT_CODE
from .policy import Action, SupervisorPolicy
from .replan import replan_for, stamped_plan
from .reshard import (TornCheckpointError, read_save_point,
                      reshard_checkpoints)
from .tailer import EventTailer

__all__ = ["ChildSpec", "Supervisor"]


# -- child argv handling -----------------------------------------------------


def _flag_value(argv, name):
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return None


def _strip_flag(argv, name):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == name:
            skip = True
            continue
        if a.startswith(name + "="):
            continue
        out.append(a)
    return out


def _set_flag(argv, name, value):
    return _strip_flag(argv, name) + [name, str(value)]


def _truthy(v) -> bool:
    return str(v) == "True"


class ChildSpec:
    """What the supervisor needs to know about the training command."""

    def __init__(self, argv: list[str], checkpoint_dir: str | None = None,
                 trace_dir: str | None = None, tag: str | None = None,
                 world: int | None = None):
        if not argv:
            raise ValueError("child command is empty")
        self.argv = list(argv)
        self.checkpoint_dir = (checkpoint_dir
                               or _flag_value(argv, "--checkpoint_dir")
                               or "./checkpoints")
        self.trace_dir = trace_dir or _flag_value(argv, "--trace_dir")
        if not self.trace_dir:
            raise ValueError("supervision needs a telemetry stream: pass "
                             "--trace_dir (supervisor flag or child flag)")
        # the reference's module and the port's
        # (stochastic_gradient_push_torch.run.gossip_lm) both name it
        self.is_lm = any("gossip_lm" in a for a in argv)
        default_tag = "lm_" if self.is_lm else ""
        self.tag = tag if tag is not None else (
            _flag_value(argv, "--tag") or default_tag)
        w = world if world is not None else _flag_value(argv, "--world_size")
        if w is None:
            raise ValueError("supervision needs the world size: pass "
                             "--world_size in the child command (or the "
                             "supervisor's --world)")
        self.world = int(w)
        # planner-relevant child configuration (used when the stamped
        # checkpoint plan is missing, e.g. a legacy --graph_type launch)
        self.all_reduce = _truthy(_flag_value(argv, "--all_reduce"))
        self.bilat = _truthy(_flag_value(argv, "--bilat"))
        push_sum = _flag_value(argv, "--push_sum")
        self.algorithm = ("sgp" if push_sum is None or _truthy(push_sum)
                          else "dpsgd")
        self.gossip = not (self.all_reduce or self.bilat)
        self.overlap = _truthy(_flag_value(argv, "--overlap"))
        self.faults = bool(_flag_value(argv, "--inject_faults"))
        self.gap_floor = float(_flag_value(argv, "--gap_floor") or 0.01)

    def build_argv(self, world: int, plan: dict | None,
                   resume: bool, extra: dict | None = None) -> list[str]:
        """The generation's launch command: managed flags rewritten, the
        rest of the operator's command preserved verbatim.  ``extra``
        maps additional flags to values (a fleet assignment rewrites
        ``--num_processes``/``--process_id`` this way)."""
        argv = _strip_flag(self.argv, "--requeue_command")
        argv = _set_flag(argv, "--world_size", world)
        argv = _set_flag(argv, "--trace_dir", self.trace_dir)
        if resume:
            # relaunched generations always resume from the resharded
            # checkpoint; generation 0 keeps the operator's own --resume
            argv = _set_flag(argv, "--resume", "True")
        if plan is not None:
            argv = _set_flag(argv, "--topology", plan["topology"])
            for name in ("--global_avg_every", "--slice_size",
                         "--mixing_alpha", "--synth_seed",
                         "--synth_budget", "--synth_beam",
                         "--synth_phases"):
                argv = _strip_flag(argv, name)
            if plan.get("global_avg_every"):
                argv += ["--global_avg_every",
                         str(plan["global_avg_every"])]
            # a plan's own slice_size is the hierarchical decomposition;
            # flat/synthesized plans priced on a sliced fabric carry the
            # slice only in the interconnect stamp — without it the
            # child's surviving --dcn_cost would be rejected at launch
            # (make_interconnect: dcn_cost needs slice structure)
            slice_size = plan.get("slice_size") or (
                (plan.get("interconnect") or {}).get("slice_size"))
            if slice_size:
                argv += ["--slice_size", str(slice_size)]
            if plan.get("alpha") is not None:
                argv += ["--mixing_alpha", str(plan["alpha"])]
            if plan["topology"] == "synth" and plan.get("synth"):
                # relaunch with the stamp's search knobs: the child's
                # deterministic re-search (same seed/budget/world)
                # re-derives the stamped schedule, and the resumed
                # checkpoint's own stamp seeds it regardless
                for flag, key in (("--synth_seed", "seed"),
                                  ("--synth_budget", "budget"),
                                  ("--synth_beam", "beam_width"),
                                  ("--synth_phases", "max_phases")):
                    if plan["synth"].get(key) is not None:
                        argv += [flag, str(plan["synth"][key])]
        for name, value in (extra or {}).items():
            argv = _set_flag(argv, name, value)
        return argv


# -- supervisor --------------------------------------------------------------


class Supervisor:
    def __init__(self, spec: ChildSpec,
                 policy: SupervisorPolicy | None = None, *,
                 poll_interval_s: float = 0.5,
                 drain_timeout_s: float = 300.0,
                 stall_timeout_s: float = 0.0,
                 child_env: dict | None = None,
                 install_signal_handlers: bool = True,
                 chaos_kill_after_checkpoint: bool = False,
                 fleet=None, fleet_timeout_s: float = 600.0,
                 fleet_join: bool = False,
                 on_relaunch=None, log=None):
        self.spec = spec
        self.policy = policy or SupervisorPolicy(world=spec.world)
        # fleet mode: a FleetMember (supervise/coordinator.py) — this
        # supervisor is one host of a pod; relaunch decisions come from
        # the coordinator's broadcast stream instead of being made here
        self.fleet = fleet
        self.fleet_timeout_s = fleet_timeout_s
        # joiner mode: this host is NOT in the coordinator's launch
        # membership — before launching any child it says hello (the
        # join request), waits for the coordinated grow cycle, reshards
        # its shard of the n -> n' upward reshard, and only launches on
        # the coordinator's go
        self.fleet_join = bool(fleet_join)
        if self.fleet_join and fleet is None:
            raise ValueError("fleet_join requires a FleetMember")
        self.poll_interval_s = poll_interval_s
        self.drain_timeout_s = drain_timeout_s
        # > 0: a live child with NO event traffic for this long counts as
        # a lost heartbeat (hung collective).  Needs an event cadence
        # (--metrics_every / --health_every) to be meaningful
        self.stall_timeout_s = stall_timeout_s
        # the child inherits the operator's environment (the card
        # included: the supervisor itself never touches it)
        self.child_env = dict(child_env if child_env is not None
                              else os.environ)
        # mark the child as supervised: the run layer then leaves
        # requeueing to us instead of running `scontrol requeue` itself
        self.child_env["SGP_SUPERVISED"] = "1"
        self._install_handlers = install_signal_handlers
        # selftest chaos injection: SIGKILL the child once its first
        # whole checkpoint set lands (simulated rank loss with a
        # restart point)
        self.chaos_kill_after_checkpoint = chaos_kill_after_checkpoint
        self.on_relaunch = on_relaunch  # hook(report, plan) — selftest
        self.log = log or make_logger("supervisor")
        os.makedirs(spec.trace_dir, exist_ok=True)
        self.registry = TelemetryRegistry(rank=0, sinks=[
            JsonlSink(os.path.join(spec.trace_dir,
                                   SUPERVISOR_EVENTS_FILE)),
            LoggerCompatSink(self.log)])
        self.tailer = EventTailer(os.path.join(spec.trace_dir,
                                               EVENTS_FILE))
        if self.fleet is not None:
            self.fleet.bind(self.registry)
        self._preempted = False
        self._child: subprocess.Popen | None = None
        self._fleet_call: dict | None = None
        # broadcast events polled but not yet acted on: a poll() batch
        # can carry more than the event we return on (call + assign in
        # one flush), and the tailer never re-delivers — the remainder
        # must survive into the fleet-cycle loop
        self._fleet_backlog: list[dict] = []

    # -- signals -----------------------------------------------------------

    def _on_signal(self, signum, frame):
        self.log.warning("supervisor received %s; draining the child",
                         signal.Signals(signum).name)
        self._preempted = True

    # -- event emit --------------------------------------------------------

    def _emit(self, action: str, severity: str = "info", **data):
        self.registry.emit("supervisor",
                           {"action": action,
                            "generation": self.policy.generation,
                            "world": self.policy.world, **data},
                           severity=severity)

    def _emit_relaunch(self, *, world: int, prev_world: int, reason: str,
                       plan: dict | None, report, t_detect: float,
                       backoff_s: float = 0.0, **extra):
        """The generation-boundary event — ONE schema for the
        single-host and fleet paths (obsreport's restart timeline
        parses exactly these keys)."""
        self.registry.emit("relaunch", {
            "generation": self.policy.generation,
            "world": world, "prev_world": prev_world,
            "reason": reason,
            "topology": plan.get("topology") if plan else None,
            "global_avg_every": (plan.get("global_avg_every")
                                 if plan else None),
            "mixing_alpha": plan.get("alpha") if plan else None,
            "slice_size": plan.get("slice_size") if plan else None,
            "resharded": report is not None,
            "mean_drift": (report.mean_drift if report is not None
                           else None),
            "backoff_s": round(backoff_s, 3),
            "time_to_recover_s": round(time.time() - t_detect, 3),
            **extra}, severity="warning")

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> int:
        """Supervise until the run completes, the restart budget is
        spent, or a preemption signal arrives.  Returns the exit code
        the launch layer should propagate."""
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
        plan: dict | None = None
        extra: dict | None = None
        resume = False
        if self.fleet_join:
            # grow-the-world induction: no child exists yet — the hello
            # below is the join request, and the first launch happens
            # only on the coordinator's go, with the grown world's plan
            # and this host's assigned shard already resharded
            self.tailer.poll()
            self.fleet.poll()   # the broadcast tailer replays from byte
            # 0: drop history so we only act on our own grow cycle
            self._emit("fleet-join", severity="warning",
                       reason=f"joining the fleet with "
                              f"{self.fleet.rows} row(s)")
            self.fleet.hello(world=self.policy.world, generation=0,
                             child_pid=None)
            outcome = self._fleet_cycle(
                Action("fleet-join", reason="joining the fleet"))
            if isinstance(outcome, int):
                return outcome
            plan, extra = outcome
            resume = True
        while True:
            argv = self.spec.build_argv(self.policy.world, plan, resume,
                                        extra=extra)
            self._emit("launch", reason="initial" if resume is False
                       else "relaunch")
            self.log.info("launching generation %d (world %d): %s",
                          self.policy.generation, self.policy.world,
                          " ".join(argv))
            self._child = subprocess.Popen(argv, env=self.child_env)
            if self.fleet is not None:
                self.fleet.hello(world=self.policy.world,
                                 generation=self.policy.generation,
                                 child_pid=self._child.pid)
            action = self._watch()
            if action.kind == "complete":
                if self.fleet is not None:
                    self.fleet.done(0)
                self._emit("run-complete", reason=action.reason)
                return 0
            if action.kind == "preempt-exit":
                self._drain_child()
                self._emit("preempt-exit", severity="warning",
                           reason=action.reason)
                return REQUEUE_EXIT_CODE
            if self.fleet is not None:
                # fleet mode: the coordinator owns the relaunch cycle
                outcome = self._fleet_cycle(action)
                if isinstance(outcome, int):
                    return outcome
                plan, extra = outcome
                resume = True
                continue
            if action.kind == "give-up":
                self._emit("gave-up", severity="error",
                           reason=action.reason)
                self._kill_child()
                return 1
            # a relaunch cycle: drain/kill, reshard, replan, go again
            t_detect = time.time()
            self._emit("restart-decision", severity="warning",
                       reason=action.reason, kind=action.kind)
            if action.kind == "drain-restart":
                self._drain_child()
            else:
                self._kill_child()
            # discard the dead generation's event tail (a draining child
            # keeps emitting until its save lands): stale recovery
            # suggestions must not leak into the next generation's
            # debounce streak
            self.tailer.poll()
            new_world = self.policy.target_world(action.shrink)
            plan = self._replan(new_world)
            report = None
            try:
                report = reshard_checkpoints(
                    self.spec.checkpoint_dir, self.spec.tag,
                    self.policy.world, new_world, plan=plan)
                self.log.warning(
                    "resharded checkpoints n=%d -> n=%d "
                    "(consensus collapse, mean drift %.2e)",
                    self.policy.world, new_world, report.mean_drift)
            except (TornCheckpointError, ValueError) as e:
                self.log.warning(
                    "no reshardable checkpoint (%s); relaunching cold "
                    "at world %d", e, new_world)
            prev_world = self.policy.world
            # a crash/stall is a failure for backoff purposes; a healthy
            # drain (requeue, sustained replan) relaunches immediately
            self.policy.mark_relaunched(new_world,
                                        failure=action.kind == "restart")
            backoff_s = self.policy.next_backoff_s()
            self._emit_relaunch(world=new_world, prev_world=prev_world,
                                reason=action.reason, plan=plan,
                                report=report, t_detect=t_detect,
                                backoff_s=backoff_s)
            if self.on_relaunch is not None:
                self.on_relaunch(report, plan)
            if backoff_s > 0:
                self.log.info("relaunch backoff: sleeping %.2fs "
                              "(%d consecutive failure(s))", backoff_s,
                              self.policy.consecutive_failures)
                time.sleep(backoff_s)
            resume = True

    # -- child management --------------------------------------------------

    def _watch(self) -> Action:
        """Poll the child and its event stream until an action is due."""
        child = self._child
        chaos_armed = self.chaos_kill_after_checkpoint
        launch_t = time.time()
        last_event_t = launch_t
        # stall grace is per GENERATION: a relaunched child recompiles
        # from scratch and must not inherit the previous generation's
        # "already emitting" status
        seen_at_launch = self.tailer.events_seen
        while True:
            for ev in self.tailer.poll():
                last_event_t = time.time()
                act = self.policy.observe(ev)
                if act is not None:
                    return act
            if self.fleet is not None:
                self.fleet.maybe_alive(child.pid if child.poll() is None
                                       else None)
                act = self._check_fleet_stream()
                if act is not None:
                    return act
            if self._preempted:
                return Action("preempt-exit",
                              reason="supervisor received a preemption "
                                     "signal")
            if chaos_armed and self._whole_set_landed(child, launch_t):
                # selftest chaos: the restart point exists — lose a rank
                self.log.warning("chaos: SIGKILLing child pid %d (first "
                                 "checkpoint set landed)", child.pid)
                self._emit("chaos-kill", severity="warning",
                           reason="selftest rank loss injection")
                child.kill()
                # one-shot across the supervisor's lifetime, not per
                # generation: the relaunched child must run to completion
                chaos_armed = self.chaos_kill_after_checkpoint = False
            rc = child.poll()
            if rc is not None:
                # drain any events flushed right before exit — the final
                # run_meta may carry the exit reason
                for ev in self.tailer.poll():
                    self.policy.observe(ev)
                return self.policy.on_child_exit(rc)
            if (self.stall_timeout_s > 0
                    and time.time() - last_event_t > self.stall_timeout_s
                    and self.tailer.events_seen > seen_at_launch):
                return self.policy.on_stale(time.time() - last_event_t)
            time.sleep(self.poll_interval_s)

    def _whole_set_landed(self, child, since: float) -> bool:
        """Every rank file of this generation's world written after
        ``since``, all of one save.  On True the child is left stopped
        (the caller kills it); a set caught mid-save, or a file not
        there yet, lets it go on."""
        paths = [os.path.join(self.spec.checkpoint_dir,
                              f"{self.spec.tag}checkpoint_r{r}_"
                              f"n{self.policy.world}.ckpt")
                 for r in range(self.policy.world)]
        try:
            if any(os.path.getmtime(p) < since for p in paths):
                return False
        except OSError:
            return False
        if child.poll() is not None:
            return False
        child.send_signal(signal.SIGSTOP)
        # the stop lands asynchronously: wait, without reaping, until the
        # child is stopped (or gone), so no save runs while the files'
        # save points are read
        os.waitid(os.P_PID, child.pid,
                  os.WSTOPPED | os.WEXITED | os.WNOWAIT)
        try:
            points = {read_save_point(p) for p in paths}
        except (OSError, RuntimeError, ValueError, EOFError,
                pickle.UnpicklingError):
            points = set()
        if len(points) == 1:
            return True
        child.send_signal(signal.SIGCONT)
        return False

    # -- fleet mode --------------------------------------------------------

    def _check_fleet_stream(self) -> Action | None:
        """Coordinator broadcasts observed while the child is healthy:
        a rendezvous call (another host died — drain and join) or a
        fleet halt (pod preemption).  Whatever follows the returned-on
        event in the same poll batch is kept for the fleet-cycle loop."""
        batch = self._fleet_backlog + self.fleet.poll()
        self._fleet_backlog = []
        for i, ev in enumerate(batch):
            data = ev.get("data") or {}
            phase = data.get("phase")
            if ev.get("kind") == "rendezvous" and phase == "call":
                self._fleet_call = data
                self._fleet_backlog.extend(batch[i + 1:])
                return Action("fleet-rendezvous",
                              reason="coordinator rendezvous call "
                                     f"(round {data.get('round')}: "
                                     f"{data.get('cause', '?')})")
            if ev.get("kind") == "fleet" and phase == "halt":
                return Action("preempt-exit",
                              reason="coordinator halted the fleet")
        return None

    def _fleet_cycle(self, action: Action):
        """One host's side of the coordinated relaunch cycle: report
        (or answer) the fault, rendezvous, reshard the assigned shard,
        ack, and wait for go.  Returns ``(plan, extra_flags)`` to
        relaunch with, or an exit code to propagate."""
        t_detect = time.time()
        self._emit("restart-decision", severity="warning",
                   reason=action.reason, kind=action.kind)
        if action.kind in ("fleet-rendezvous", "drain-restart",
                           "relaunch"):
            # healthy child (or one that already checkpointed): the
            # SIGUSR1 barrier is the clean shard boundary
            self._drain_child()
        else:
            self._kill_child()
        if action.kind not in ("fleet-rendezvous", "fleet-join"):
            self.fleet.fault(reason=action.reason, action=action.kind)
        # discard the dead generation's event tail (same discipline as
        # the single-host path: stale suggestions must not leak)
        self.tailer.poll()
        if self._fleet_call is not None:
            self.fleet.join(self._fleet_call["round"])
            self._fleet_call = None
        assign = None
        deadline = time.time() + self.fleet_timeout_s
        while True:
            batch = self._fleet_backlog + self.fleet.poll()
            self._fleet_backlog = []
            if batch:
                # the timeout guards against a DEAD coordinator, not a
                # long cycle: any broadcast traffic (a re-run barrier,
                # another survivor's slow ack window) re-arms it
                deadline = time.time() + self.fleet_timeout_s
            for i, ev in enumerate(batch):
                data = ev.get("data") or {}
                phase = data.get("phase")
                if ev.get("kind") == "rendezvous" and phase == "call":
                    # every (re-)run of the barrier supersedes whatever
                    # assignment was in flight
                    assign = None
                    self.fleet.join(data["round"])
                elif ev.get("kind") == "fleet" and phase == "assign":
                    shard = (data.get("shards") or {}).get(
                        str(self.fleet.host))
                    if shard is not None:
                        assign = data
                        self._fleet_reshard(assign, shard)
                    elif self.fleet.host in (data.get("excluded") or []):
                        self._emit("excluded", severity="warning",
                                   reason="coordinator excluded this "
                                          "host from the new world")
                        return EXCLUDED_EXIT_CODE
                elif ev.get("kind") == "fleet" and phase == "go" \
                        and assign is not None \
                        and data.get("round") == assign.get("round"):
                    # the batch tail (e.g. an immediately-following
                    # rendezvous call) survives into the next
                    # generation's _check_fleet_stream — the tailer
                    # never re-delivers
                    self._fleet_backlog.extend(batch[i + 1:])
                    return self._fleet_relaunch(assign, action, t_detect)
                elif ev.get("kind") == "fleet" and phase in (
                        "halt", "give-up", "complete"):
                    self._emit("fleet-exit", severity="warning",
                               reason=f"coordinator {phase}")
                    return (REQUEUE_EXIT_CODE if phase == "halt" else 1)
            if self._preempted:
                self._emit("preempt-exit", severity="warning",
                           reason="supervisor received a preemption "
                                  "signal mid-rendezvous")
                return REQUEUE_EXIT_CODE
            if time.time() > deadline:
                self._emit("fleet-timeout", severity="error",
                           reason="no coordinator broadcast traffic "
                                  f"for {self.fleet_timeout_s:.0f}s")
                return 1
            time.sleep(self.poll_interval_s)

    def _fleet_reshard(self, assign: dict, shard: dict) -> None:
        """Reshard this host's assigned shard of the cross-world
        collapse — run CONCURRENTLY by every survivor — then ack with the
        measured boundary drift.  The reference's one file of
        ``out_rows`` rows at ``out_rank`` is the rank files
        ``rank_offset .. rank_offset + out_rows - 1`` here: disjoint
        atomic writes that compose into one set."""
        report = None
        lo = int(shard["rank_offset"])
        try:
            report = reshard_checkpoints(
                self.spec.checkpoint_dir, self.spec.tag,
                assign["prev_world"], assign["world"],
                ranks=range(lo, lo + int(shard["out_rows"])),
                plan=assign.get("plan"))
            self.log.warning(
                "fleet reshard: n=%d -> n=%d, my shard r%d (%d rows), "
                "mean drift %.2e", assign["prev_world"],
                assign["world"], shard["out_rank"], shard["out_rows"],
                report.mean_drift)
        except (TornCheckpointError, ValueError) as e:
            self.log.warning("fleet reshard found no usable source set "
                             "(%s); relaunching cold", e)
        self._fleet_report = report
        self.fleet.ack(assign["round"], ok=report is not None,
                       mean_drift=(report.mean_drift
                                   if report is not None else None),
                       out_rank=shard["out_rank"],
                       out_rows=shard["out_rows"])

    def _fleet_relaunch(self, assign: dict, action: Action, t_detect):
        """The coordinator committed: adopt the assignment and hand the
        relaunch flags back to the generation loop."""
        shard = assign["shards"][str(self.fleet.host)]
        prev_world = self.policy.world
        self.policy.mark_relaunched(assign["world"], failure=False)
        plan = assign.get("plan")
        report = getattr(self, "_fleet_report", None)
        self._emit_relaunch(
            world=assign["world"], prev_world=prev_world,
            reason=f"fleet-assign ({assign.get('cause', '?')})",
            plan=plan, report=report, t_detect=t_detect,
            out_rank=shard["out_rank"], out_rows=shard["out_rows"])
        extra = {"--num_processes": shard["num_hosts"],
                 "--process_id": shard["host_index"]}
        # children that address their rows explicitly (the host-sim
        # trainer, the decode child) get them rewritten too; real run
        # CLIs derive rank ownership from the process layout and never
        # pass these
        if _flag_value(self.spec.argv, "--rows") is not None:
            extra["--rows"] = shard["out_rows"]
        if _flag_value(self.spec.argv, "--rank_offset") is not None:
            extra["--rank_offset"] = shard["rank_offset"]
        return plan, extra

    def _drain_child(self) -> int | None:
        """SIGUSR1 → wait for the checkpoint barrier (the child exits
        REQUEUE_EXIT_CODE strictly after its save); SIGKILL on timeout."""
        child = self._child
        if child is None or child.poll() is not None:
            return child.poll() if child else None
        self.log.info("draining child pid %d (SIGUSR1)", child.pid)
        child.send_signal(signal.SIGUSR1)
        try:
            rc = child.wait(timeout=self.drain_timeout_s)
            if rc != REQUEUE_EXIT_CODE:
                self.log.warning("drained child exited %d (expected the "
                                 "requeue code %d)", rc, REQUEUE_EXIT_CODE)
            return rc
        except subprocess.TimeoutExpired:
            self.log.warning(
                "child did not reach the checkpoint barrier within "
                "%.0fs; killing it (the last epoch checkpoint is the "
                "restart point)", self.drain_timeout_s)
            return self._kill_child()

    def _kill_child(self) -> int | None:
        child = self._child
        if child is None:
            return None
        if child.poll() is None:
            child.kill()
        return child.wait()

    # -- replanning --------------------------------------------------------

    def _stamped_plan(self) -> dict | None:
        """The plan the run launched with (supervise/replan.py)."""
        return stamped_plan(self.spec.checkpoint_dir, self.spec.tag)

    def _replan(self, world: int) -> dict | None:
        """A fresh ``planner.plan_for`` for ``world`` under the run's
        stamped constraints (supervise/replan.py — the same helper the
        pod coordinator re-plans the whole fleet with)."""
        return replan_for(world, self._stamped_plan(),
                          gossip=self.spec.gossip,
                          algorithm=self.spec.algorithm,
                          gap_floor=self.spec.gap_floor,
                          overlap=self.spec.overlap,
                          faults=self.spec.faults, log=self.log)
