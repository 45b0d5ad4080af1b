"""Decode-fleet child: a serving process under the training supervisor.

Port of ``stochastic_gradient_push_tpu/serve/child.py``, the host-sim's
counterpart for the serving axis (``supervise/hostsim.py`` is the
training twin): a numpy decode worker that speaks every host-side
contract the fleet fabric expects, so a **decode fleet** reshards and
relaunches under the ``Supervisor``/``Coordinator`` with no supervision
code of its own:

* the host-sim's managed CLI surface (``--world_size --num_processes
  --process_id --rows --rank_offset --resume ...``), so the fleet's
  ``ChildSpec`` argv rewriting drives it unchanged;
* consensus ingest at launch: a reshardable checkpoint set under
  ``--checkpoint_dir`` is collapsed through :func:`.load.load_consensus`
  (a torn, foreign or missing set falls through to a seeded cold model:
  a serving child comes up whatever training left behind);
* the port's rank files — the served consensus replicated over this
  host's rank rows with ``ps_weight`` 1, saved through the host-sim's
  world barrier (:class:`~..supervise.hostsim.HostFiles`) — so the
  coordinator's cross-world reshard of a decode fleet is exact by
  construction (identical replicas collapse to themselves);
* the typed event stream: ``run_meta`` at launch, ``step_stats`` per
  serve tick (the supervisor's liveness heartbeat), a ``serve`` summary
  on exit;
* the SIGUSR1/SIGTERM drain: finish the in-flight tick and exit
  ``REQUEUE_EXIT_CODE`` (75), saving as the host-sim does.

Traffic is the deterministic :class:`.bench.SyntheticEngine` stream
through :class:`.scheduler.ContinuousBatcher`: continuous batching and
the page table on every tick, no device.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np

from ..supervise.hostsim import HostFiles
from ..telemetry import EVENTS_FILE, JsonlSink, TelemetryRegistry
from ..utils.checkpoint import REQUEUE_EXIT_CODE
from .bench import SyntheticEngine, summarize, synthetic_requests
from .engine import ServeConfig
from .load import ConsensusIngestError, load_consensus
from .scheduler import AdmissionError, ContinuousBatcher

__all__ = ["main"]

PARAM_DIM = 16          # the host-sim's layout: the fleets interoperate


def _ingest(directory: str, tag: str, seed: int):
    """The served model: the consensus collapse of whatever checkpoint
    set training (or a previous decode fleet) left behind, else a
    seeded cold model.  Returns ``(w_bar [PARAM_DIM], source)``."""
    from ..supervise.reshard import CheckpointMetaError, TornCheckpointError

    try:
        params, _, info = load_consensus(directory, tag)
    except (ConsensusIngestError, TornCheckpointError,
            CheckpointMetaError, ValueError):
        # the cold model is deterministic, so replicas still agree
        w = np.random.default_rng(seed).standard_normal(
            PARAM_DIM).astype(np.float32)
        return w, "cold"
    leaf = params.get("w")
    if leaf is None:
        # an LM or image set: serve a digest row (the synthetic engine
        # needs only a deterministic function of the consensus)
        flat = [np.asarray(v, np.float64).ravel() for v in params.values()]
        vec = np.concatenate(flat) if flat else np.zeros(1)
        w = np.resize(vec.astype(np.float32), PARAM_DIM)
    else:
        w = np.resize(np.asarray(leaf, np.float32).ravel(), PARAM_DIM)
    return w, f"consensus_n{info.world}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="servechild",
        description="Decode-fleet child: consensus ingest + continuous "
                    "batching under the fleet supervisor contracts")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--trace_dir", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--world_size", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--rows", type=int, required=True,
                    help="rank rows this host owns")
    ap.add_argument("--rank_offset", type=int, default=None)
    ap.add_argument("--steps", type=int, default=40,
                    help="serve ticks before a clean exit")
    ap.add_argument("--save_every", type=int, default=5)
    ap.add_argument("--step_s", type=float, default=0.05,
                    help="simulated serving time per tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests_per_step", type=int, default=2)
    ap.add_argument("--resume", default="False")
    args = ap.parse_args(argv)

    if args.rows < 1 or args.rows > args.world_size:
        print(f"servechild: --rows {args.rows} outside [1, world]",
              file=sys.stderr)
        return 2
    offset = (args.rank_offset if args.rank_offset is not None
              else args.process_id * args.rows)

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    os.makedirs(args.trace_dir, exist_ok=True)
    registry = TelemetryRegistry(rank=args.process_id, sinks=[
        JsonlSink(os.path.join(args.trace_dir, EVENTS_FILE))])

    signalled: list[int] = []
    old_handlers = {
        sig: signal.signal(sig,
                           lambda signum, frame: signalled.append(signum))
        for sig in (signal.SIGUSR1, signal.SIGTERM)}

    w_bar, source = _ingest(args.checkpoint_dir, args.tag, args.seed)
    # the reshardable serving state: the consensus replicated over this
    # host's rows, unit ps-weight — identical replicas collapse to
    # themselves, so any cross-world reshard of the decode fleet is
    # exact
    state = {
        "params": {"w": np.broadcast_to(
            w_bar[None], (args.rows, PARAM_DIM)).copy()},
        "gossip": {
            "ps_weight": np.ones(args.rows, np.float32),
            "phase": np.zeros(args.rows, np.int32)},
    }
    files = HostFiles(args.checkpoint_dir, args.tag, args.world_size,
                      args.num_processes, args.process_id, offset,
                      args.rows)
    files.mark(staged=0, committed=0)
    committed = 0

    def meta_for(t: int) -> dict:
        # no plan/health: the serve-time meta is the stripped shape the
        # reshard path must tolerate (supervise/reshard.py meta_key)
        return {"step": t, "world": args.world_size, "rows": args.rows,
                "process_id": args.process_id,
                "num_processes": args.num_processes,
                "epoch": 0, "itr": t, "serve": True}

    engine = SyntheticEngine(
        ServeConfig(n_heads=1, page_size=4, num_pages=32, max_seqs=4,
                    max_pages_per_seq=8),
        seed=int(np.abs(w_bar).sum() * 1000) % (2 ** 31))
    batcher = ContinuousBatcher(engine, registry=registry)
    stream = synthetic_requests(
        max(1, args.steps) * args.requests_per_step,
        seed=args.seed + 17 * args.process_id,
        prompt_tokens=(3, 8), new_tokens=(2, 6))
    next_rid = 0

    registry.emit("run_meta", {
        "world": args.world_size, "algorithm": "servechild",
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "rows": args.rows, "rank_offset": offset,
        "model_source": source, "serve": True, "fleet": True})

    def drained() -> bool:
        return bool(signalled)

    rc = 0
    tick = 0
    t0 = time.monotonic()
    try:
        while tick < args.steps:
            time.sleep(args.step_s)
            for _ in range(args.requests_per_step):
                if next_rid < len(stream):
                    try:
                        batcher.submit(stream[next_rid])
                    except AdmissionError:
                        pass     # counted + emitted by the batcher
                    next_rid += 1
            batcher.step()
            tick += 1
            registry.emit("step_stats", {
                "step": tick, "loss": 0.0,
                "requests_completed": len(batcher.completed),
                "requests_active": batcher.active,
                "page_occupancy": engine.pages.occupancy()},
                step=tick)
            if signalled:
                if args.num_processes == 1:
                    files.save(state, meta_for(tick), committed, drained)
                    committed = tick
                registry.emit("run_meta", {
                    "exit_reason": "preempted",
                    "signal": int(signalled[0]),
                    "exit_code": REQUEUE_EXIT_CODE, "step": committed})
                rc = REQUEUE_EXIT_CODE
                break
            if tick % args.save_every == 0 or tick == args.steps:
                if not files.save(state, meta_for(tick), committed,
                                  drained):
                    registry.emit("run_meta", {
                        "exit_reason": "preempted",
                        "signal": int(signalled[0]),
                        "exit_code": REQUEUE_EXIT_CODE, "step": committed})
                    rc = REQUEUE_EXIT_CODE
                    break
                committed = tick
        else:
            if tick == 0:
                files.save(state, meta_for(tick), committed, drained)
            registry.emit("run_meta", {
                "exit_reason": "complete", "exit_code": 0, "step": tick})
        batcher.drain()
        registry.emit("serve", dict(
            summarize(batcher.completed, time.monotonic() - t0,
                      rejected=batcher.rejected,
                      peak_occupancy=batcher.peak_occupancy,
                      decode_steps=batcher.decode_steps),
            phase="summary"))
    finally:
        registry.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)   # in-process callers (tests) recover
    return rc


if __name__ == "__main__":
    sys.exit(main())
