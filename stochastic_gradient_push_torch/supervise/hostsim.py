"""A simulated per-host trainer: the fleet chaos selftest's child.

Port of ``stochastic_gradient_push_tpu/supervise/hostsim.py``.  The
fleet selftest (``scripts/torch_fleet.py --selftest``) needs a *fleet*
of children — one per simulated host, each owning its slice of one
gossip world — that it can SIGKILL a whole host of and still assert
exact consensus preservation across the coordinated reshard.  What it
exercises is the supervision fabric (rendezvous, exclusion, concurrent
per-host reshard, coordinated relaunch), so this trainer is numpy with
no device at all, speaking every host-side contract the run CLIs speak:

* the port's checkpoint layout: one ``torch.save`` file a rank,
  ``{tag}checkpoint_r{rank}_n{world}.ckpt`` holding ``{"state": row,
  "meta": <JSON text>}`` as ``utils/checkpoint.py`` writes it (``row``
  = ``step``, ``params/w``, ``gossip/ps_weight``, ``gossip/phase``);
* the typed event stream (``events.jsonl``: ``run_meta`` at launch,
  ``step_stats`` per step) the per-host supervisor tails;
* the SIGUSR1/SIGTERM drain: finish the in-flight step and exit
  ``REQUEUE_EXIT_CODE``;
* ``--resume`` from its own rank files, including ones another world's
  coordinator reshard wrote, with the stamped ``meta['plan']`` carried
  forward across saves.

The argv, the seeded rows and the step update are the reference's, so
the same arguments give the same rows.

**One save of the world.**  The reference writes one file a host, so a
kill leaves each host's rows old or new whole; here each rank has its
file and the loader refuses a set whose files come from different saves
(``supervise/reshard.py``).  The hosts of one world therefore save in
step, as the processes of a synchronous run do: at a save step each
host stages its files (``.tmp.r{rank}``, fsynced), marks them staged,
waits until every host of the world has staged that step, then renames
*every* host's staged files and marks the step committed (a rename
another host already made is skipped).  Before staging the next save it
waits until every host committed the last one.  The marks carry the
generation's key — the world's rank files as the hosts found them at
launch, which every host of a generation sees alike — so a mark left
by an earlier generation is never taken for a peer's.  So a host killed
at any point leaves the set at one save: all staged files are renamed
by whoever commits, or none is.  A host waiting on a dead peer waits as a
process does in a collective with a lost rank, until its supervisor
drains it.  A host of several does not save on a drain (its peers are
at other steps, and a save there would mix the set), and a drain that
lands while it stages leaves the save before the step is marked staged:
its restart point is the last committed save, and the steps since are
recomputed the same on resume.  A host alone saves at the drain's step,
as the reference's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np

from ..telemetry import EVENTS_FILE, JsonlSink, TelemetryRegistry
from ..utils.checkpoint import REQUEUE_EXIT_CODE

__all__ = ["main", "HostFiles"]

PARAM_DIM = 16
# how often a host waiting at the save barrier reads its peers' marks
BARRIER_POLL_S = 0.005


def _step_update(w: np.ndarray, rank_offset: int, step: int,
                seed: int) -> np.ndarray:
    """One deterministic pseudo-SGD step per rank row: reproducible for
    a given (seed, global rank, step), different across ranks — the
    consensus mean moves, and moves the same way on every rerun."""
    out = w.copy()
    for i in range(w.shape[0]):
        rng = np.random.default_rng(
            seed * 100_003 + (rank_offset + i) * 1_009 + step)
        out[i] += 0.01 * rng.standard_normal(w.shape[1:]).astype(w.dtype)
    return out


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class HostFiles:
    """One host's rank files of one world, and the world's save barrier
    (module docstring): ``{tag}hostsim_p{proc}_n{world}.sync`` holds
    ``{"key": generation, "staged": step, "committed": step}`` for each
    host.  Construct it before this generation writes anything.
    ``fsync=False`` leaves a staged file's durability to the page cache
    (a host that is a thread, whose kill loses nothing written);
    ``poll_s`` is how often a waiting host reads its peers' marks."""

    def __init__(self, directory: str, tag: str, world: int,
                 num_processes: int, process_id: int, rank_offset: int,
                 rows: int, fsync: bool = True,
                 poll_s: float = BARRIER_POLL_S):
        self.directory = directory
        self.fsync = bool(fsync)
        self.poll_s = float(poll_s)
        self.tag = tag
        self.world = int(world)
        self.num_processes = int(num_processes)
        self.process_id = int(process_id)
        self.ranks = list(range(rank_offset, rank_offset + rows))
        found = []
        for r in range(self.world):
            try:
                st = os.stat(self.path(r))
            except OSError:
                continue
            found.append((r, st.st_mtime_ns, st.st_size))
        self.key = hashlib.sha1(repr(found).encode()).hexdigest()
        for r in self.ranks:   # this host's staging left by a kill
            try:
                os.remove(self.path(r) + f".tmp.r{r}")
            except OSError:
                pass

    def path(self, rank: int) -> str:
        return os.path.join(self.directory,
                            f"{self.tag}checkpoint_r{rank}_n{self.world}"
                            ".ckpt")

    def _sync(self, proc: int) -> str:
        return os.path.join(self.directory, f"{self.tag}hostsim_p{proc}_"
                                            f"n{self.world}.sync")

    def mark(self, staged: int, committed: int) -> None:
        _write_json(self._sync(self.process_id),
                    {"key": self.key, "staged": staged,
                     "committed": committed})

    def _wait(self, field: str, step: int, stop) -> bool:
        """Until every host's ``field`` mark of this generation is at
        least ``step``; False when ``stop()`` turned true first (a
        drain)."""
        while True:
            marks = [_read_json(self._sync(p))
                     for p in range(self.num_processes)]
            if all(m is not None and m.get("key") == self.key
                   and m.get(field, -1) >= step for m in marks):
                return True
            if stop():
                return False
            time.sleep(self.poll_s)

    def load(self):
        """``(rows, meta)`` from this host's rank files, ``None`` when it
        has none; ``ValueError`` when it has some but not all, or they
        come from different saves."""
        import torch

        have = [r for r in self.ranks if os.path.isfile(self.path(r))]
        if not have:
            return None
        if have != self.ranks:
            raise ValueError(
                f"checkpoint holds rows {have} of this host's "
                f"{len(self.ranks)} ({self.ranks[0]}..{self.ranks[-1]})")
        raws = [torch.load(self.path(r), map_location="cpu",
                           weights_only=True) for r in self.ranks]
        metas = [json.loads(raw["meta"]) for raw in raws]
        if len({m.get("step") for m in metas}) != 1:
            raise ValueError("this host's rank files come from different "
                             "saves")
        state = {
            "params": {"w": np.stack([raw["state"]["params"]["w"].numpy()
                                      for raw in raws])},
            "gossip": {
                "ps_weight": np.array(
                    [float(raw["state"]["gossip"]["ps_weight"])
                     for raw in raws], np.float32),
                "phase": np.array([int(raw["state"]["gossip"]["phase"])
                                   for raw in raws], np.int32)}}
        return state, metas[0]

    def _stage(self, state: dict, meta: dict, stop=None) -> bool:
        """Write this host's staged files; False when a host of several
        is drained part-way (``stop()``): it then never marks the step
        staged, so no host commits it."""
        import torch

        text = json.dumps(meta)
        g = state["gossip"]
        for j, r in enumerate(self.ranks):
            if stop is not None and self.num_processes > 1 and stop():
                return False
            row = {"step": int(meta["step"]),
                   "params": {"w": torch.from_numpy(
                       np.array(state["params"]["w"][j]))},
                   "gossip": {"phase": int(g["phase"][j]),
                              "ps_weight": torch.tensor(
                                  float(g["ps_weight"][j]))}}
            tmp = self.path(r) + f".tmp.r{r}"
            with open(tmp, "wb") as f:
                torch.save({"state": row, "meta": text}, f)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
        return True

    def _rename_all(self) -> None:
        for r in range(self.world):
            try:
                os.replace(self.path(r) + f".tmp.r{r}", self.path(r))
            except FileNotFoundError:
                pass   # another host renamed it, or no host owns r

    def save(self, state: dict, meta: dict, last: int, stop) -> bool:
        """One save of the world at ``meta['step']`` (module docstring);
        ``last`` is the step of this host's last committed save.  False
        when a drain interrupted it before the commit (a host of several
        leaves at once, even mid-stage; a host alone completes it)."""
        step = int(meta["step"])
        if not self._wait("committed", last, stop):
            return False
        if not self._stage(state, meta, stop):
            return False
        self.mark(staged=step, committed=last)
        if not self._wait("staged", step, stop):
            return False
        self._rename_all()
        self.mark(staged=step, committed=step)
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hostsim",
        description="Simulated per-host trainer for fleet supervision "
                    "tests (numpy; the port's checkpoint and event "
                    "contracts)")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--trace_dir", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--world_size", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--rows", type=int, required=True,
                    help="rank rows this host owns")
    ap.add_argument("--rank_offset", type=int, default=None,
                    help="first global rank of this host's rows "
                         "(default: process_id * rows — uniform slices)")
    ap.add_argument("--steps", type=int, default=40,
                    help="total training steps (global counter; resume "
                         "continues it)")
    ap.add_argument("--save_every", type=int, default=5)
    ap.add_argument("--step_s", type=float, default=0.05,
                    help="simulated compute per step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default="False")
    args = ap.parse_args(argv)

    if args.rows < 1 or args.rows > args.world_size:
        print(f"hostsim: --rows {args.rows} outside [1, world]",
              file=sys.stderr)
        return 2
    offset = (args.rank_offset if args.rank_offset is not None
              else args.process_id * args.rows)

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    os.makedirs(args.trace_dir, exist_ok=True)
    files = HostFiles(args.checkpoint_dir, args.tag, args.world_size,
                      args.num_processes, args.process_id, offset,
                      args.rows)

    signalled: list[int] = []
    old_handlers = {
        sig: signal.signal(sig,
                           lambda signum, frame: signalled.append(signum))
        for sig in (signal.SIGUSR1, signal.SIGTERM)}

    step = 0
    plan = None
    state = None
    if str(args.resume) == "True":
        try:
            loaded = files.load()
        except ValueError as e:
            print(f"hostsim: {e}, launched with --rows {args.rows}",
                  file=sys.stderr)
            return 2
        if loaded is not None:
            state, meta = loaded
            step = int(meta.get("step", 0))
            plan = meta.get("plan")
    if state is None:
        w = np.stack([
            np.random.default_rng(args.seed * 100_003 + (offset + i))
            .standard_normal(PARAM_DIM).astype(np.float32)
            for i in range(args.rows)])
        state = {
            "params": {"w": w},
            "gossip": {
                "ps_weight": np.ones(args.rows, np.float32),
                "phase": np.zeros(args.rows, np.int32)},
        }
    # this generation's barrier starts at its resume point
    files.mark(staged=step, committed=step)
    committed = step

    def meta_for(s: int) -> dict:
        m = {"step": s, "world": args.world_size, "rows": args.rows,
             "process_id": args.process_id,
             "num_processes": args.num_processes, "epoch": 0, "itr": s}
        if plan is not None:
            m["plan"] = plan
        return m

    registry = TelemetryRegistry(rank=args.process_id, sinks=[
        JsonlSink(os.path.join(args.trace_dir, EVENTS_FILE))])
    registry.emit("run_meta", {
        "world": args.world_size, "algorithm": "hostsim",
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "rows": args.rows, "rank_offset": offset,
        "resumed_step": step, "fleet": True})

    def drained() -> bool:
        return bool(signalled)

    def preempted(at: int) -> int:
        registry.emit("run_meta", {
            "exit_reason": "preempted", "signal": int(signalled[0]),
            "exit_code": REQUEUE_EXIT_CODE, "step": at})
        return REQUEUE_EXIT_CODE

    rc = 0
    try:
        while step < args.steps:
            time.sleep(args.step_s)
            state["params"]["w"] = _step_update(
                state["params"]["w"], offset, step, args.seed)
            step += 1
            registry.emit("step_stats", {
                "step": step,
                "loss": float(np.abs(state["params"]["w"]).mean())},
                step=step)
            if signalled:
                if args.num_processes == 1:
                    files.save(state, meta_for(step), committed, drained)
                    committed = step
                rc = preempted(committed)
                break
            if step % args.save_every == 0 or step == args.steps:
                if not files.save(state, meta_for(step), committed,
                                  drained):
                    rc = preempted(committed)
                    break
                committed = step
        else:
            if step == 0:
                files.save(state, meta_for(step), committed, drained)
            registry.emit("run_meta", {
                "exit_reason": "complete", "exit_code": 0, "step": step})
    finally:
        registry.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)   # in-process callers (tests) recover
    return rc


if __name__ == "__main__":
    sys.exit(main())
