"""Per-rank checkpoints and preemption handling.

Port of ``CheckpointManager``, ``ClusterManager`` and
``REQUEUE_EXIT_CODE`` in ``stochastic_gradient_push_tpu/utils/
checkpoint.py``, with the port's own file format:

* **One file per gossip rank** — decentralized ranks hold different
  models, so each rank's row of the rank-stacked train state is saved
  on its own, under the reference's names: ``{tag}checkpoint_r{rank}_
  n{world}.ckpt``, ``ep{epoch}_`` prefixed when epochs are kept apart,
  and ``{tag}model_best_r{rank}_n{world}.ckpt`` on a validation best.
  The state carries the push-sum weight, the overlap FIFO and, with
  error feedback, the residual (``gossip/ef_residual``); the
  trainer drains the FIFO (``algorithms.drain_state``) before it saves,
  so nothing is in flight on disk.
* **The payload** is one ``torch.save`` per file: ``{"state": ...,
  "meta": <JSON text>}`` with the rank's tensors on the CPU, the step
  and phase as ints, and the reference's meta keys (epoch, itr,
  best_prec1, elapsed_time, the three timing meters, the launch-time
  topology ``plan`` when the CLI made one and, with health monitoring,
  the last ``health`` payload), written to a
  temporary name and renamed, so state and meta never disagree.  It is
  read with ``weights_only=True``.  The reference's flax msgpack is not
  read: that needs JAX.
* **Preemption**: SIGUSR1/SIGTERM set a flag (also a file beside the
  checkpoints); at the next step boundary the trainer saves and exits
  with :data:`REQUEUE_EXIT_CODE`, after an optional requeue command.

``all_workers=False`` (the CLI's ``--checkpoint_all False``) keeps
rank 0's file alone, the original's rank-0-only checkpoint: rank 0's
row is saved, and a resume starts every rank from it.  It needs every
rank in this process (the stacked lane).

A checkpoint set of another world size is found (``discover_worlds``)
but not resharded: cross-world resume (``supervise/reshard.py``) is not
ported, and the trainer refuses it by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal

import torch

from ..algorithms.api import GossipState
from .logging import make_logger

__all__ = ["CheckpointManager", "ClusterManager", "REQUEUE_EXIT_CODE"]

# exit status of a run that checkpointed in response to SIGUSR1/SIGTERM
# and wants to be relaunched (EX_TEMPFAIL, "try again later"): distinct
# from 0 (run complete) and from crash codes
REQUEUE_EXIT_CODE = 75


def _row(state, j: int) -> dict:
    """Row ``j`` of a rank-stacked train state as a plain dict of CPU
    tensors and ints."""
    def rows(tree):
        return {n: t[j].detach().cpu().clone() for n, t in tree.items()}

    g = state.gossip
    gossip = {"phase": int(g.phase),
              "ps_weight": g.ps_weight[j].detach().cpu().clone(),
              "in_flight": [{"params": rows(p),
                             "ps_weight": w[j].detach().cpu().clone()}
                            for p, w in g.in_flight]}
    if g.ef_residual is not None:
        gossip["ef_residual"] = rows(g.ef_residual)
    return {"step": int(state.step), "params": rows(state.params),
            "opt_state": rows(state.opt_state),
            "batch_stats": rows(state.batch_stats), "gossip": gossip}


def _stack(template: dict, rows: list[dict], what: str) -> dict:
    """Rank rows of one dict of tensors stacked into ``template``'s
    shapes, dtypes and device."""
    out = {}
    for r in rows:
        if set(r) != set(template):
            raise ValueError(
                f"checkpoint {what} do not match the run's: missing "
                f"{sorted(set(template) - set(r))}, extra "
                f"{sorted(set(r) - set(template))}")
    for n, t in template.items():
        got = torch.stack([r[n] for r in rows])
        if got.shape != t.shape:
            raise ValueError(f"checkpoint {what} {n}: shape "
                             f"{tuple(got.shape)}, the run's {tuple(t.shape)}")
        out[n] = got.to(device=t.device, dtype=t.dtype)
    return out


class CheckpointManager:
    """Save and restore the rank rows ``ranks`` of a rank-stacked train
    state (row ``j`` is rank ``ranks[j]``), one file per rank, or rank
    0's file alone with ``all_workers=False``."""

    def __init__(self, directory: str, tag: str = "", world_size: int = 1,
                 ranks=(0,), all_workers: bool = True):
        self.directory = directory
        self.tag = tag
        self.world_size = int(world_size)
        self.ranks = [int(r) for r in ranks]
        self.all_workers = bool(all_workers)
        os.makedirs(directory, exist_ok=True)

    def _sources(self) -> list[int]:
        """The rank file each held rank is saved to and restored from."""
        return self.ranks if self.all_workers else [0] * len(self.ranks)

    def path(self, rank: int, epoch_id: int | None = None) -> str:
        """Rank ``rank``'s file, ``ep{epoch_id}_`` prefixed when given."""
        base = f"{self.tag}checkpoint_r{rank}_n{self.world_size}.ckpt"
        if epoch_id is not None:
            base = f"ep{epoch_id}_{base}"
        return os.path.join(self.directory, base)

    def best_path(self, rank: int) -> str:
        return os.path.join(
            self.directory,
            f"{self.tag}model_best_r{rank}_n{self.world_size}.ckpt")

    def save(self, state, meta: dict, epoch_id: int | None = None,
             is_best: bool = False) -> list[str]:
        meta_text = json.dumps(meta, default=float)
        written = []
        for j, rank in enumerate(self.ranks):
            if not self.all_workers and rank != 0:
                continue
            path = self.path(rank, epoch_id)
            tmp = path + ".tmp"
            torch.save({"state": _row(state, j), "meta": meta_text}, tmp)
            os.replace(tmp, path)
            if path != self.path(rank):
                # the canonical resume path follows the newest save
                shutil.copyfile(path, self.path(rank))
            if is_best:
                shutil.copyfile(path, self.best_path(rank))
            written.append(path)
        return written

    def exists(self) -> bool:
        return all(os.path.isfile(self.path(r)) for r in self._sources())

    def discover_worlds(self) -> list[int]:
        """World sizes of other checkpoint sets in this directory (any
        rank), the current world excluded."""
        pat = re.compile(re.escape(self.tag)
                         + r"checkpoint_r(\d+)_n(\d+)\.ckpt$")
        worlds = {int(m.group(2)) for f in os.listdir(self.directory)
                  if (m := pat.match(f))}
        worlds.discard(self.world_size)
        return sorted(worlds)

    def restore(self, template) -> tuple[object, dict]:
        """The saved rows stacked into ``template``'s structure (a train
        state of the same run configuration), and the meta."""
        files = {r: torch.load(self.path(r), map_location="cpu",
                               weights_only=True)
                 for r in set(self._sources())}
        blobs = [files[r] for r in self._sources()]
        rows = [b["state"] for b in blobs]
        if len({(r["step"], r["gossip"]["phase"]) for r in rows}) != 1:
            raise ValueError("rank files disagree on the step or the "
                             "gossip phase")
        g = template.gossip
        if any(len(r["gossip"]["in_flight"]) != len(g.in_flight)
               for r in rows):
            raise ValueError(
                "checkpoint in-flight FIFO depth does not match the run's "
                f"({len(rows[0]['gossip']['in_flight'])} vs "
                f"{len(g.in_flight)}): resume with the same overlap and "
                "staleness")
        in_flight = tuple(
            (_stack(p, [r["gossip"]["in_flight"][k]["params"]
                        for r in rows], "in-flight params"),
             torch.stack([r["gossip"]["in_flight"][k]["ps_weight"]
                          for r in rows]).to(device=w.device,
                                             dtype=w.dtype))
            for k, (p, w) in enumerate(g.in_flight))
        saved_ef = ["ef_residual" in r["gossip"] for r in rows]
        if any(saved_ef) != (g.ef_residual is not None) or (
                len(set(saved_ef)) > 1):
            raise ValueError(
                "checkpoint error-feedback residual does not match the "
                f"run's (saved: {any(saved_ef)}, this run: "
                f"{g.ef_residual is not None}): resume with the same "
                "--wire_dtype and --error_feedback")
        ef_residual = None
        if g.ef_residual is not None:
            ef_residual = _stack(g.ef_residual,
                                 [r["gossip"]["ef_residual"] for r in rows],
                                 "ef residual")
        ps_weight = torch.stack([r["gossip"]["ps_weight"] for r in rows])
        state = dataclasses.replace(
            template, step=rows[0]["step"],
            params=_stack(template.params, [r["params"] for r in rows],
                          "params"),
            opt_state=_stack(template.opt_state,
                             [r["opt_state"] for r in rows], "opt_state"),
            batch_stats=_stack(template.batch_stats,
                               [r["batch_stats"] for r in rows],
                               "batch_stats"),
            gossip=GossipState(
                phase=rows[0]["gossip"]["phase"],
                ps_weight=ps_weight.to(device=g.ps_weight.device,
                                       dtype=g.ps_weight.dtype),
                in_flight=in_flight, ef_residual=ef_residual))
        return state, json.loads(blobs[0]["meta"])


class ClusterManager:
    """Signal-aware checkpoint coordinator: SIGUSR1/SIGTERM raise a flag
    that the trainer checks at each step boundary."""

    def __init__(self, checkpoint_manager: CheckpointManager,
                 rank: int = 0, requeue_command: str | None = None,
                 install_handlers: bool = True):
        self.ckpt = checkpoint_manager
        self.rank = rank
        self.requeue_command = requeue_command
        self.signal_received = False
        self.last_signal: str | None = None
        # one rank per process: the trainer sets this to a collective
        # "any process", so every process acts at the same step
        self.agree = None
        self.logger = make_logger(rank)
        self._flag_path = os.path.join(
            self.ckpt.directory, f"{self.ckpt.tag}.preempt_flag")
        # a stale flag from a killed run must not make the requeued job
        # exit again after its first epoch; the flag is not removed at
        # exit, so every process of a run sees it
        try:
            os.remove(self._flag_path)
        except OSError:
            pass
        if install_handlers:
            self.install_signal_handlers()

    def install_signal_handlers(self) -> None:
        signal.signal(signal.SIGUSR1, self._sigusr1)
        signal.signal(signal.SIGTERM, self._sigterm)
        self.logger.info("Signal handlers installed")

    def _sigterm(self, signum, frame):
        self.logger.info("Received SIGTERM")
        self.last_signal = "SIGTERM"
        self._raise_flag()

    def _sigusr1(self, signum, frame):
        self.logger.info("Received SIGUSR1")
        self.last_signal = "SIGUSR1"
        self._raise_flag()

    def _raise_flag(self):
        self.signal_received = True
        try:
            with open(self._flag_path, "w") as f:
                f.write("1")
        except OSError as e:
            self.logger.warning(f"could not write preempt flag: {e}")

    def local_signalled(self) -> bool:
        """A signal reached this process, or another left the flag."""
        return self.signal_received or os.path.isfile(self._flag_path)

    def any_rank_signalled(self) -> bool:
        flag = self.local_signalled()
        return flag if self.agree is None else self.agree(flag)

    def save_checkpoint(self, state, meta: dict, epoch_id: int | None = None,
                        is_best: bool = False,
                        requeue_on_signal: bool = True) -> None:
        """Save; then, when a signal was seen and ``requeue_on_signal``,
        run the requeue command (rank 0) and exit
        :data:`REQUEUE_EXIT_CODE`."""
        self.logger.info("Saving checkpoint")
        self.ckpt.save(state, meta, epoch_id=epoch_id, is_best=is_best)
        if requeue_on_signal and self.any_rank_signalled():
            self.logger.info(
                "At least 1 process received SIGUSR1. Terminating")
            if self.rank == 0 and self.requeue_command:
                self.logger.info("Relaunching: " + self.requeue_command)
                if os.system(self.requeue_command):
                    raise RuntimeError("requeue command failed")
                self.logger.info("New job submitted to the queue")
            raise SystemExit(REQUEUE_EXIT_CODE)
