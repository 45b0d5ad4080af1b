"""What ``scripts/torch_supervise.py`` runs: supervised runs and the
selftest.

Port of ``stochastic_gradient_push_tpu/supervise/cli.py``.  Modes:

* ``-- <training command>`` — supervise a run of either port CLI
  (``python -m stochastic_gradient_push_torch.run.gossip_sgd`` /
  ``.gossip_lm``): launch it as a managed child, tail its typed event
  stream, and drive the checkpoint → reshard → replan → relaunch cycle
  on rank loss, sustained re-plan suggestions, stalls, crashes, or
  preemption;
* ``--selftest`` — the elastic acceptance loop: a world-8 stacked
  ``gossip_sgd`` child is SIGKILLed after its first whole checkpoint set
  (simulated rank loss), the supervisor reshards the rank files 8→4 by
  exact-average consensus collapse, re-plans for world 4, and
  relaunches; the selftest then checks that the run completed at world
  4, a fresh plan is stamped into the new checkpoint meta, exactly one
  relaunch happened, and the consensus mean is kept across the boundary
  to f32 tolerance (computed from the files).  The child runs on the
  card; ``--device cpu`` is forwarded to it to run on the CPU.

Exit codes: 0 clean, 1 selftest failure / restart budget spent,
75 (``REQUEUE_EXIT_CODE``) preemption passthrough — the wrapping launch
script requeues the job, 2 unusable configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ..utils.checkpoint import REQUEUE_EXIT_CODE

SELFTEST_WORLD = 8
SELFTEST_SHRUNK = 4
SELFTEST_TOL = 1e-5


def selftest_child(d: str, world: int, device: str | None = None,
                   num_epochs: int = 4) -> list[str]:
    """The selftest's training command: the port's image CLI, stacked,
    ``tiny_cnn`` on synthetic data, its checkpoints and events in
    ``d``."""
    child = [sys.executable, "-m",
             "stochastic_gradient_push_torch.run.gossip_sgd",
             "--dataset", "synthetic", "--world_size", str(world),
             "--model", "tiny_cnn", "--num_classes", "4",
             "--image_size", "8", "--batch_size", "4",
             "--num_epochs", str(num_epochs), "--num_itr_ignore", "0",
             "--num_iterations_per_training_epoch", "2",
             "--print_freq", "1", "--verbose", "False",
             "--topology", "auto",
             "--checkpoint_dir", d, "--trace_dir", d]
    if device is not None:
        child += ["--device", device]
    return child


def selftest(keep_dir: str | None = None, child_env: dict | None = None,
             device: str | None = None, world: int = SELFTEST_WORLD,
             shrunk: int = SELFTEST_SHRUNK, num_epochs: int = 4,
             on_boundary=None) -> int:
    """Kill-a-rank chaos e2e on a stacked child of ``world`` ranks.
    ``on_boundary(old_state, new_state)`` sees the two sets' stacked
    arrays between the reshard and the relaunch."""
    from ..telemetry import SUPERVISOR_EVENTS_FILE
    from .policy import SupervisorPolicy
    from .reshard import _load_file, consensus_mean, load_world_checkpoint
    from .supervisor import ChildSpec, Supervisor

    import numpy as np

    failures: list[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    d = keep_dir or tempfile.mkdtemp(prefix="supervise_selftest_")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(child_env if child_env is not None else os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    boundary = {}

    def verify_boundary(report, plan):
        """Independent restart-boundary check, run between the reshard
        and the relaunch (before the new generation can overwrite the
        resharded files): the consensus mean of the old set must equal
        the consensus mean of the new one."""
        old, _, _ = load_world_checkpoint(d, "", world)
        new, meta, _ = load_world_checkpoint(d, "", shrunk)
        m_old, m_new = consensus_mean(old), consensus_mean(new)
        boundary["drift"] = max(
            float(np.abs(m_old[k] - m_new[k]).max()) for k in m_old)
        boundary["report"] = report
        boundary["plan"] = plan
        boundary["meta"] = meta
        if on_boundary is not None:
            on_boundary(old, new)

    spec = ChildSpec(selftest_child(d, world, device, num_epochs))
    sup = Supervisor(
        spec,
        SupervisorPolicy(world=world, max_restarts=2, shrink_factor=2),
        poll_interval_s=0.05, drain_timeout_s=180.0,
        child_env=env, chaos_kill_after_checkpoint=True,
        on_relaunch=verify_boundary)
    rc = sup.run()

    check(rc == 0, f"supervisor exited {rc}, expected 0 (run complete)")
    check(boundary, "the chaos kill never triggered a relaunch")
    if boundary:
        check(boundary["drift"] < SELFTEST_TOL,
              f"parameter mean drifted {boundary['drift']:.2e} across "
              f"the {world}->{shrunk} restart boundary (tolerance "
              f"{SELFTEST_TOL})")
        report = boundary["report"]
        check(report is not None and report.new_world == shrunk,
              "reshard did not produce the shrunken world")
        check(report is not None and report.mean_drift < SELFTEST_TOL,
              "reshard's own drift measurement exceeded tolerance")
        plan = boundary["plan"]
        check(plan is not None and plan.get("world") == shrunk
              and plan.get("topology"),
              f"replan did not produce a world-{shrunk} plan: {plan}")
        check(boundary["meta"].get("reshard", {}).get("old_world")
              == world,
              "reshard provenance missing from the resharded metadata")

    # the supervisor's own event stream: one chaos kill, one relaunch
    sup_events = []
    sup_path = os.path.join(d, SUPERVISOR_EVENTS_FILE)
    if os.path.isfile(sup_path):
        with open(sup_path) as f:
            sup_events = [json.loads(line) for line in f if line.strip()]
    relaunches = [e for e in sup_events if e.get("kind") == "relaunch"]
    check(len(relaunches) == 1,
          f"expected exactly one relaunch event, got {len(relaunches)}")
    if relaunches:
        ev = relaunches[0]["data"]
        check(ev.get("world") == shrunk and ev.get("prev_world") == world,
              f"relaunch event worlds wrong: {ev}")
        check(ev.get("resharded") is True, "relaunch event not resharded")
        check(ev.get("topology"), "relaunch event carries no fresh "
              "topology")
    check(any(e.get("kind") == "supervisor"
              and e.get("data", {}).get("action") == "chaos-kill"
              for e in sup_events), "no chaos-kill supervisor event")

    # the relaunched generation finished the run at the shrunken world
    # and stamped a fresh plan (that world's) into its checkpoint meta
    final_path = os.path.join(d, f"checkpoint_r0_n{shrunk}.ckpt")
    check(os.path.isfile(final_path),
          f"no world-{shrunk} checkpoint after the relaunch")
    if os.path.isfile(final_path):
        _, meta = _load_file(final_path)
        check(meta.get("epoch") == num_epochs,
              f"relaunched run stopped at epoch {meta.get('epoch')}, "
              f"expected {num_epochs} (run complete)")
        plan = meta.get("plan") or {}
        check(plan.get("world") == shrunk,
              f"final checkpoint's stamped plan is {plan.get('world')}-"
              f"world, expected {shrunk}")

    if failures:
        for msg in failures:
            print(f"supervise selftest FAILED: {msg}", file=sys.stderr)
        print(f"(artifacts left in {d})", file=sys.stderr)
        return 1
    print(f"supervise selftest: OK (world {world} child killed after its "
          f"first checkpoint set -> resharded to {shrunk} with mean drift "
          f"{boundary['drift']:.2e} -> relaunched on topology "
          f"{relaunches[0]['data']['topology']!r} and ran to completion)")
    if keep_dir is None:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return 0


def main(argv=None, child_env: dict | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_supervise",
        description="Elastic run supervisor: act on re-plans, survive "
                    "rank loss, resize the world",
        epilog="everything after `--` is the training command to "
               "supervise, e.g.: torch_supervise.py --max_restarts 3 -- "
               "python -m stochastic_gradient_push_torch.run.gossip_sgd "
               "--world_size 8 --trace_dir /runs/t1 ...")
    ap.add_argument("--selftest", action="store_true",
                    help="run the elastic chaos e2e and exit")
    ap.add_argument("--selftest_dir", default=None,
                    help="keep selftest artifacts in this directory")
    ap.add_argument("--device", default=None,
                    help="selftest: the child's --device (default: the "
                         "card; cpu runs it on the CPU)")
    ap.add_argument("--trace_dir", default=None,
                    help="telemetry directory to tail (default: the "
                         "child's own --trace_dir flag)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="checkpoint directory to reshard (default: the "
                         "child's --checkpoint_dir)")
    ap.add_argument("--world", type=int, default=None,
                    help="initial world size (default: the child's "
                         "--world_size)")
    ap.add_argument("--tag", default=None,
                    help="checkpoint tag (default: the child's --tag)")
    ap.add_argument("--max_restarts", type=int, default=3,
                    help="relaunch budget before giving up (0 = "
                         "unlimited)")
    ap.add_argument("--shrink_factor", type=int, default=2,
                    help="divide the world by this on rank loss")
    ap.add_argument("--min_world", type=int, default=1,
                    help="never shrink below this many ranks")
    ap.add_argument("--replan_count", type=int, default=3,
                    help="re-plan suggestions required before a "
                         "topology-switch relaunch")
    ap.add_argument("--replan_cooldown_steps", type=int, default=20,
                    help="minimum training-step span the suggestions "
                         "must cover (debounce: one transient "
                         "suggestion never relaunches)")
    ap.add_argument("--drain_timeout", type=float, default=300.0,
                    help="seconds to wait for the SIGUSR1 checkpoint "
                         "barrier before SIGKILL")
    ap.add_argument("--stall_timeout", type=float, default=0.0,
                    help="seconds of event silence from a live child "
                         "that counts as heartbeat loss (0 = off; "
                         "needs an event cadence like --metrics_every)")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="supervisor poll interval in seconds")
    ap.add_argument("child", nargs=argparse.REMAINDER,
                    help="training command (after `--`)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(keep_dir=args.selftest_dir, child_env=child_env,
                        device=args.device)

    child = args.child
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        ap.error("no training command given (append `-- <command...>`, "
                 "or use --selftest)")
    from .policy import SupervisorPolicy
    from .supervisor import ChildSpec, Supervisor

    try:
        spec = ChildSpec(child, checkpoint_dir=args.checkpoint_dir,
                         trace_dir=args.trace_dir, tag=args.tag,
                         world=args.world)
    except ValueError as e:
        print(f"supervise: error: {e}", file=sys.stderr)
        return 2
    policy = SupervisorPolicy(
        world=spec.world, replan_count=args.replan_count,
        replan_cooldown_steps=args.replan_cooldown_steps,
        max_restarts=args.max_restarts,
        shrink_factor=args.shrink_factor, min_world=args.min_world)
    sup = Supervisor(spec, policy, poll_interval_s=args.poll,
                     drain_timeout_s=args.drain_timeout,
                     stall_timeout_s=args.stall_timeout,
                     child_env=child_env)
    rc = sup.run()
    if rc == REQUEUE_EXIT_CODE:
        print("supervise: preempted after checkpoint; exiting "
              f"{REQUEUE_EXIT_CODE} (requeue me)", file=sys.stderr)
    return rc
