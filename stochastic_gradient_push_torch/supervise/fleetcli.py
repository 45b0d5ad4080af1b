"""What ``scripts/torch_fleet.py`` runs: fleet supervision and the
selftest.

Port of ``stochastic_gradient_push_tpu/supervise/fleetcli.py``.  Modes:

* ``--coordinator`` — run the pod coordinator over a shared
  ``--fleet_dir``: tail every ``host{h}/supervisor.jsonl``, and on a
  host fault or host silence drive ONE rendezvous → assign → ack → go
  cycle for the whole fleet (supervise/coordinator.py);
* ``--host I -- <training command>`` — run host *I*'s per-host
  supervisor in fleet mode: it launches the child with its telemetry
  pointed at ``<fleet_dir>/hostI/``, answers the coordinator's
  rendezvous calls, reshards exactly its assigned shard, and relaunches
  on ``go``;
* ``--selftest`` — the fleet chaos acceptance loop: a 3-host × 2-rank
  CPU fleet (numpy host-sim children — no device, no collective
  deadlock surface) is running when an
  entire simulated slice (host 2's supervisor AND child, SIGKILL) is
  lost mid-run.  The test then asserts: the coordinator's first
  rendezvous round times out on the dead host (deadline-miss →
  re-rendezvous, not a hang), the re-run agrees at 2 hosts, both
  survivors reshard their disjoint shards of the 6→4 collapse
  *concurrently* (the rank files ``rank_offset .. rank_offset +
  out_rows - 1`` each) into one set that is not torn, whose consensus
  mean matches the old world's to float32 tolerance, exactly ONE
  coordinated
  assign→go cycle happens (no per-host relaunch storm), and the run
  completes at the shrunken world.

Exit codes: 0 clean, 1 selftest failure / fleet gave up,
75 (``REQUEUE_EXIT_CODE``) preemption passthrough, 2 unusable
configuration, 4 (``EXCLUDED_EXIT_CODE``) this host was excluded from
the new world.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..telemetry import COORDINATOR_EVENTS_FILE, SUPERVISOR_EVENTS_FILE
from ..utils.checkpoint import REQUEUE_EXIT_CODE
from .coordinator import Coordinator, FleetMember, host_dir

SELFTEST_HOSTS = 3
SELFTEST_ROWS = 2
SELFTEST_WORLD = SELFTEST_HOSTS * SELFTEST_ROWS
SELFTEST_SHRUNK = SELFTEST_WORLD - SELFTEST_ROWS
SELFTEST_STEPS = 200
SELFTEST_TOL = 1e-5


def _parse_host_rows(args) -> dict[int, int]:
    """``{host: rows}`` from --hosts/--rows or the explicit
    --host_rows csv (non-uniform slices)."""
    if args.host_rows:
        rows = [int(r) for r in args.host_rows.split(",")]
        if any(r < 1 for r in rows):
            raise ValueError(f"--host_rows entries must be >= 1: {rows}")
        return {i: r for i, r in enumerate(rows)}
    if not args.hosts or args.hosts < 1:
        raise ValueError("--coordinator needs --hosts N (or --host_rows)")
    if args.rows is None or args.rows < 1:
        raise ValueError("--coordinator with --hosts needs --rows R "
                         "(rank rows per host; or use --host_rows for "
                         "non-uniform slices)")
    return {i: args.rows for i in range(args.hosts)}


# -- selftest ---------------------------------------------------------------


def _read_events(path: str) -> list[dict]:
    out = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def _host_child_pid(d: str, host: int) -> int | None:
    """The child pid the host's supervisor last heartbeat — the handle
    slice-kill chaos uses to bury the whole simulated host."""
    pid = None
    for ev in _read_events(os.path.join(host_dir(d, host),
                                        SUPERVISOR_EVENTS_FILE)):
        if ev.get("kind") == "rendezvous":
            p = (ev.get("data") or {}).get("child_pid")
            if p:
                pid = int(p)
    return pid


def selftest(keep_dir: str | None = None, steps: int = SELFTEST_STEPS,
             step_s: float = 0.05, child_env: dict | None = None) -> int:
    """Kill-a-whole-slice chaos e2e on a simulated 3-host CPU fleet
    (``steps`` host-sim steps of ``step_s`` seconds)."""
    import numpy as np

    from .reshard import consensus_mean, load_world_checkpoint

    failures: list[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    d = keep_dir or tempfile.mkdtemp(prefix="fleet_selftest_")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(child_env if child_env is not None else os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    fleet_script = os.path.join(repo_root, "scripts", "torch_fleet.py")

    def host_cmd(h: int) -> list[str]:
        return [sys.executable, fleet_script,
                "--host", str(h), "--fleet_dir", d,
                "--poll", "0.1", "--alive_interval", "0.5",
                "--drain_timeout", "30",
                "--",
                sys.executable, "-m",
                "stochastic_gradient_push_torch.supervise.hostsim",
                "--checkpoint_dir", d, "--trace_dir", host_dir(d, h),
                "--world_size", str(SELFTEST_WORLD),
                "--num_processes", str(SELFTEST_HOSTS),
                "--process_id", str(h),
                "--rows", str(SELFTEST_ROWS),
                "--rank_offset", str(h * SELFTEST_ROWS),
                "--steps", str(steps),
                "--save_every", "5", "--step_s", str(step_s)]

    sups = [subprocess.Popen(host_cmd(h), env=env)
            for h in range(SELFTEST_HOSTS)]
    victim = SELFTEST_HOSTS - 1
    boundary: dict = {}

    def verify_boundary(assign):
        """Independent restart-boundary check, run between the fleet's
        ack collection and its go broadcast (children are still down):
        the surviving hosts' concurrent per-shard writes must compose
        into an un-torn world whose consensus equals the old one's."""
        old, _, _ = load_world_checkpoint(d, "", SELFTEST_WORLD)
        new, meta, _ = load_world_checkpoint(d, "", SELFTEST_SHRUNK)
        m_old, m_new = consensus_mean(old), consensus_mean(new)
        boundary["drift"] = max(
            float(np.abs(m_old[k] - m_new[k]).max()) for k in m_old)
        boundary["assign"] = assign
        boundary["ps_weight"] = np.asarray(
            new["gossip"]["ps_weight"]).tolist()
        boundary["meta"] = meta

    def chaos_kill():
        """SIGKILL an entire simulated slice: host ``victim``'s
        supervisor first (so nothing reacts), then its child — all
        ranks of one host gone at once, mid-run, after the whole fleet
        has checkpointed at least once (every rank file of the world)."""
        deadline = time.time() + 60
        while time.time() < deadline:
            have = all(os.path.isfile(os.path.join(
                d, f"checkpoint_r{r}_n{SELFTEST_WORLD}.ckpt"))
                for r in range(SELFTEST_WORLD))
            pid = _host_child_pid(d, victim)
            if have and pid is not None:
                break
            time.sleep(0.2)
        else:
            boundary["kill_error"] = "fleet never reached the kill point"
            return
        sups[victim].kill()
        sups[victim].wait()
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        boundary["killed"] = {"host": victim, "child_pid": pid}

    killer = threading.Thread(target=chaos_kill, daemon=True)
    killer.start()

    coord = Coordinator(
        d, {h: SELFTEST_ROWS for h in range(SELFTEST_HOSTS)},
        checkpoint_dir=d, tag="", gossip=False,
        deadline_s=2.0, host_timeout_s=2.5, hello_grace_s=30.0,
        ack_timeout_s=60.0, poll_interval_s=0.1,
        max_cycles=2, min_hosts=1, on_cycle=verify_boundary)
    rc = coord.run()
    killer.join(timeout=5)
    for p in sups:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()

    check(rc == 0, f"coordinator exited {rc}, expected 0 (fleet "
                   "complete)")
    check("killed" in boundary,
          boundary.get("kill_error", "the slice kill never happened"))
    check(boundary.get("drift") is not None,
          "the coordinated cycle never ran (no boundary to verify)")
    if boundary.get("drift") is not None:
        check(boundary["drift"] < SELFTEST_TOL,
              f"consensus mean drifted {boundary['drift']:.2e} across "
              f"the {SELFTEST_WORLD}->{SELFTEST_SHRUNK} boundary")
        check(all(w == 1.0 for w in boundary["ps_weight"]),
              f"resharded ps_weight not reset: {boundary['ps_weight']}")
        assign = boundary["assign"]
        check(assign.get("world") == SELFTEST_SHRUNK
              and sorted(assign.get("excluded", [])) == [victim],
              f"assignment wrong: {assign}")
        shards = assign.get("shards") or {}
        ranks = sorted((s["out_rank"], s["out_rows"])
                       for s in shards.values())
        check(ranks == [(0, SELFTEST_ROWS), (1, SELFTEST_ROWS)],
              f"shard assignment wrong: {shards}")

    coord_evs = _read_events(os.path.join(d, COORDINATOR_EVENTS_FILE))
    calls = [e for e in coord_evs if e.get("kind") == "rendezvous"
             and e["data"].get("phase") == "call"]
    gos = [e for e in coord_evs if e.get("kind") == "fleet"
           and e["data"].get("phase") == "go"]
    assigns = [e for e in coord_evs if e.get("kind") == "fleet"
               and e["data"].get("phase") == "assign"]
    check(len(calls) >= 2,
          f"expected the deadline-missed rendezvous to RE-RUN "
          f"(>= 2 calls), saw {len(calls)}")
    check(len(gos) == 1 and len(assigns) == 1,
          f"expected exactly one coordinated assign->go cycle, saw "
          f"{len(assigns)} assign(s) / {len(gos)} go(s)")
    if gos:
        g = gos[0]["data"]
        check(g.get("world") == SELFTEST_SHRUNK
              and g.get("prev_world") == SELFTEST_WORLD,
              f"go event worlds wrong: {g}")

    # no per-host relaunch storm: each survivor relaunched exactly once,
    # on the coordinator's go; the dead host never relaunched
    for h in range(SELFTEST_HOSTS):
        evs = _read_events(os.path.join(host_dir(d, h),
                                        SUPERVISOR_EVENTS_FILE))
        relaunches = [e for e in evs if e.get("kind") == "relaunch"]
        if h == victim:
            check(not relaunches,
                  f"dead host {h} somehow relaunched: {relaunches}")
        else:
            check(len(relaunches) == 1,
                  f"host {h}: expected exactly 1 coordinated relaunch, "
                  f"saw {len(relaunches)}")
            if relaunches:
                r = relaunches[0]["data"]
                check(r.get("reason", "").startswith("fleet-assign")
                      and r.get("world") == SELFTEST_SHRUNK,
                      f"host {h} relaunch not coordinated: {r}")

    # the run completed at the shrunken world: the final n4 set is
    # un-torn and trained through to the last step
    try:
        _, meta, files = load_world_checkpoint(d, "", SELFTEST_SHRUNK)
        check(meta.get("step") == steps,
              f"shrunken world stopped at step {meta.get('step')}, "
              f"expected {steps}")
        check(len(files) == SELFTEST_SHRUNK,
              f"expected {SELFTEST_SHRUNK} rank files, got {len(files)}")
    except Exception as e:  # a load failure is a failed check
        check(False, f"no usable world-{SELFTEST_SHRUNK} set after the "
                     f"run: {e}")

    if failures:
        for msg in failures:
            print(f"fleet selftest FAILED: {msg}", file=sys.stderr)
        print(f"(artifacts left in {d})", file=sys.stderr)
        return 1
    print(f"fleet selftest: OK ({SELFTEST_HOSTS}x{SELFTEST_ROWS}-rank "
          f"fleet, host {victim} slice SIGKILLed -> {len(calls)} "
          f"rendezvous round(s), excluded {[victim]} -> concurrent "
          f"reshard {SELFTEST_WORLD}->{SELFTEST_SHRUNK} with mean "
          f"drift {boundary['drift']:.2e} -> one coordinated relaunch "
          f"-> ran to step {steps})")
    if keep_dir is None:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return 0


# -- entry ------------------------------------------------------------------


def main(argv=None, child_env: dict | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_fleet",
        description="Two-level fleet supervision: per-host supervisors "
                    "+ a pod coordinator that survive whole-slice loss",
        epilog="host mode: everything after `--` is that host's "
               "training command")
    ap.add_argument("--selftest", action="store_true",
                    help="run the fleet chaos e2e and exit")
    ap.add_argument("--selftest_dir", default=None,
                    help="keep selftest artifacts in this directory")
    ap.add_argument("--fleet_dir", default=None,
                    help="shared fleet directory: coordinator.jsonl + "
                         "one host{h}/ dir per host")
    ap.add_argument("--coordinator", action="store_true",
                    help="run the pod coordinator")
    ap.add_argument("--host", type=int, default=None,
                    help="run host I's per-host supervisor (fleet mode)")
    ap.add_argument("--join", action="store_true",
                    help="host mode: this host is NOT in the "
                         "coordinator's launch membership — say hello "
                         "as a join request, wait for the coordinated "
                         "grow cycle (upward reshard n -> n'), and "
                         "launch the child only on the coordinator's "
                         "go")
    ap.add_argument("--hosts", type=int, default=None,
                    help="coordinator: number of hosts (uniform slices)")
    ap.add_argument("--rows", type=int, default=None,
                    help="rank rows per host (host mode: this host's "
                         "slice; default from the child's --rows flag)")
    ap.add_argument("--host_rows", default=None,
                    help="coordinator: csv of per-host rows for "
                         "non-uniform slices (overrides --hosts/--rows)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="shared checkpoint directory (default: the "
                         "fleet dir / the child's --checkpoint_dir)")
    ap.add_argument("--tag", default=None,
                    help="checkpoint tag (host mode default: the "
                         "child's --tag).  The COORDINATOR cannot see "
                         "any child argv — for an LM fleet pass "
                         "--tag lm_ explicitly, or replans lose the "
                         "stamped plan constraints")
    # the coordinator re-plans for the whole fleet, so it must know the
    # planner-relevant child configuration the single-host supervisor
    # derives from the child argv (the stamped checkpoint plan carries
    # wire/synth/fabric, but not these) — they MUST match the children
    ap.add_argument("--algorithm", default="sgp",
                    choices=["sgp", "dpsgd", "all_reduce", "bilat"],
                    help="coordinator: the children's algorithm; "
                         "all_reduce/bilat disable replanning entirely "
                         "(nothing to plan).  Must match the child "
                         "flags or the assigned plan would be one the "
                         "children reject at launch")
    ap.add_argument("--overlap", default="False",
                    help="coordinator: children run overlapped gossip "
                         "(True/False) — constrains the replan to "
                         "overlap-capable schedules")
    ap.add_argument("--faults", default="False",
                    help="coordinator: children run --inject_faults "
                         "(True/False) — the replan then avoids "
                         "schedules without per-edge fault masks")
    ap.add_argument("--gap_floor", type=float, default=0.01,
                    help="coordinator: planner spectral-gap floor for "
                         "replans (used when no stamped plan exists)")
    ap.add_argument("--deadline", type=float, default=10.0,
                    help="rendezvous barrier deadline in seconds; a "
                         "host that misses it is excluded and the "
                         "rendezvous re-runs.  Hosts join AFTER "
                         "draining their child (the drain's save is "
                         "the shard boundary), so set this comfortably "
                         "above the child's checkpoint drain time")
    ap.add_argument("--host_timeout", type=float, default=15.0,
                    help="seconds of heartbeat silence after which a "
                         "host counts as lost")
    ap.add_argument("--hello_grace", type=float, default=120.0,
                    help="startup grace before a never-seen host "
                         "counts as lost")
    ap.add_argument("--ack_timeout", type=float, default=300.0,
                    help="seconds to wait for per-host reshard acks")
    ap.add_argument("--max_cycles", type=int, default=3,
                    help="coordinated relaunch cycles before giving up")
    ap.add_argument("--min_hosts", type=int, default=1,
                    help="give up rather than continue below this many "
                         "hosts")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="host mode: local relaunch budget (0 = "
                         "unlimited — the coordinator owns the cycle "
                         "budget)")
    ap.add_argument("--drain_timeout", type=float, default=300.0,
                    help="host mode: SIGUSR1 checkpoint-barrier wait")
    ap.add_argument("--fleet_timeout", type=float, default=600.0,
                    help="host mode: seconds of coordinator broadcast "
                         "silence mid-cycle before giving up (any "
                         "traffic — a re-run barrier, other hosts' "
                         "ack windows — re-arms it; this detects a "
                         "dead coordinator, not a long cycle)")
    ap.add_argument("--alive_interval", type=float, default=2.0,
                    help="host mode: heartbeat cadence")
    ap.add_argument("--poll", type=float, default=0.25,
                    help="poll interval in seconds (both modes)")
    ap.add_argument("child", nargs=argparse.REMAINDER,
                    help="host mode: training command (after `--`)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(keep_dir=args.selftest_dir, child_env=child_env)

    if args.coordinator and args.host is not None:
        ap.error("--coordinator and --host are different processes")
    if not args.fleet_dir and (args.coordinator or args.host is not None):
        ap.error("--fleet_dir is required (the shared fleet directory)")

    if args.coordinator:
        try:
            hosts = _parse_host_rows(args)
        except ValueError as e:
            print(f"fleet: error: {e}", file=sys.stderr)
            return 2
        coord = Coordinator(
            args.fleet_dir, hosts,
            checkpoint_dir=args.checkpoint_dir, tag=args.tag or "",
            gossip=args.algorithm in ("sgp", "dpsgd"),
            algorithm=args.algorithm,
            overlap=str(args.overlap) == "True",
            faults=str(args.faults) == "True",
            gap_floor=args.gap_floor,
            deadline_s=args.deadline, host_timeout_s=args.host_timeout,
            hello_grace_s=args.hello_grace,
            ack_timeout_s=args.ack_timeout,
            poll_interval_s=args.poll, max_cycles=args.max_cycles,
            min_hosts=args.min_hosts)
        rc = coord.run()
        if rc == REQUEUE_EXIT_CODE:
            print("fleet: coordinator preempted; fleet halted, exiting "
                  f"{REQUEUE_EXIT_CODE} (requeue me)", file=sys.stderr)
        return rc

    if args.host is None:
        ap.error("choose a mode: --selftest, --coordinator, or "
                 "--host I -- <command>")

    child = args.child
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        ap.error("host mode needs a training command after `--`")
    from .policy import SupervisorPolicy
    from .supervisor import ChildSpec, Supervisor, _flag_value

    rows = args.rows
    if rows is None:
        rows_flag = _flag_value(child, "--rows")
        if rows_flag is None:
            ap.error("host mode needs --rows (or a child --rows flag)")
        rows = int(rows_flag)
    hdir = host_dir(args.fleet_dir, args.host)
    try:
        spec = ChildSpec(child, checkpoint_dir=args.checkpoint_dir,
                         trace_dir=hdir, tag=args.tag)
    except ValueError as e:
        print(f"fleet: error: {e}", file=sys.stderr)
        return 2
    member = FleetMember(args.fleet_dir, args.host, rows,
                         alive_interval_s=args.alive_interval)
    policy = SupervisorPolicy(world=spec.world,
                              max_restarts=args.max_restarts,
                              jitter_salt=args.host)
    sup = Supervisor(spec, policy, poll_interval_s=args.poll,
                     drain_timeout_s=args.drain_timeout,
                     fleet=member, fleet_timeout_s=args.fleet_timeout,
                     fleet_join=args.join, child_env=child_env)
    rc = sup.run()
    if rc == REQUEUE_EXIT_CODE:
        print("fleet: host preempted after checkpoint; exiting "
              f"{REQUEUE_EXIT_CODE} (requeue me)", file=sys.stderr)
    return rc
