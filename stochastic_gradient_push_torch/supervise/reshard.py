"""Reshard a run's per-rank checkpoint set to a new world size.

Port of ``stochastic_gradient_push_tpu/supervise/reshard.py``, the
restart-boundary transform, over the port's own file layout
(``utils/checkpoint.py``):

1. **collapse**: the exact push-sum consensus ``x̄ = Σᵢ paramsᵢ / Σᵢ
   ps_weightᵢ`` over the old world (mass conservation makes that ratio
   the network mean under any column-stochastic mixing), with the
   overlap FIFO's in-flight shares folded in once;
2. **re-stack**: the consensus replicated at the new world, ps-weight 1
   and gossip phase 0 (the new world runs a new schedule).

The network-wide parameter mean is kept across the boundary by
construction; :class:`ReshardReport` measures the realized drift (the
cast back to the leaf dtype) from the arrays.

**The layout it reads** (``utils/checkpoint.py::_row``): one
``torch.save`` file a gossip rank, ``{tag}checkpoint_r{rank}_
n{world}.ckpt``, holding ``{"state": row, "meta": <JSON text>}``, where
``row`` is ``{"step": int, "params": {name: tensor}, "opt_state": {...},
"batch_stats": {...}, "gossip": {"phase": int, "ps_weight": 0-d tensor,
"in_flight": [{"params": {...}, "ps_weight": ...}, ...], "ef_residual":
{...} (with error feedback)}}``.  Where the reference's one-process
msgpack file holds every rank row, a set here is complete only with one
file for each rank ``0 .. world-1``: a ``--checkpoint_all False`` set
(rank 0's file alone) cannot give ``Σx/Σw`` and is rejected as torn,
naming the flag.

:func:`load_world_checkpoint` stacks a set into numpy arrays with a
leading rank dim (``step`` and ``phase`` too, one int a row), the
reference's in-memory form, so the leaf rules and their float64
arithmetic are the reference's statement for statement and the results
are bit-equal to its own on the same arrays.  A tensor numpy cannot
hold (bf16) is refused by name: the port keeps parameters, momentum
and the push-sum weight in fp32.

Writes are atomic (a ``.tmp.r{rank}`` file, fsync, ``os.replace``);
the new meta drops the old world's ``health`` and carries ``reshard``
= :meth:`ReshardReport.to_dict`.  The old set stays in place (the
rollback path).  Host code only: numpy and ``torch.load``/``torch.save``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import typing as tp

import numpy as np
import torch

__all__ = ["TornCheckpointError", "CheckpointMetaError", "ReshardReport",
           "load_world_checkpoint", "consensus_mean", "meta_key",
           "reshard_state", "reshard_checkpoints",
           "maybe_cross_world_reshard", "gc_stale_tmp"]

_CKPT_RE = re.compile(r"^checkpoint_r(\d+)_n(\d+)\.ckpt$")
# a writer's in-flight atomic-rename staging file; see gc_stale_tmp
_TMP_RE = re.compile(r"^checkpoint_r\d+_n\d+\.ckpt\.tmp\.r\d+$")

# how old a *.ckpt.tmp.r{rank} file must be before readers remove it:
# long enough that a live concurrent writer is never raced, short enough
# that a killed writer's files do not outlive the next relaunch
STALE_TMP_AGE_S = 60.0


class TornCheckpointError(RuntimeError):
    """A checkpoint set that does not assemble to its full world: a rank
    file missing (half the files of a preempted save, or the single file
    of a ``--checkpoint_all False`` run)."""


class CheckpointMetaError(RuntimeError):
    """Checkpoint metadata that cannot carry the requested resume: a
    payload that is not a mapping, or a required key the set lacks.
    ``key`` names the missing key (None for a malformed payload)."""

    def __init__(self, message: str, key: str | None = None):
        super().__init__(message)
        self.key = key


def meta_key(meta: dict, key: str, context: str = ""):
    """A required checkpoint-meta key, or :class:`CheckpointMetaError`
    naming it (optional keys are read with ``meta.get``)."""
    if not isinstance(meta, dict):
        raise CheckpointMetaError(
            f"checkpoint meta must be a mapping, got "
            f"{type(meta).__name__}{f' ({context})' if context else ''}")
    if key not in meta:
        have = ", ".join(sorted(map(str, meta))) or "<empty>"
        raise CheckpointMetaError(
            f"checkpoint meta lacks required key '{key}'"
            f"{f' ({context})' if context else ''}; present: {have}",
            key=key)
    return meta[key]


def _items(tree):
    """``(key, child)`` pairs of a dict, or of a list by its indices."""
    if isinstance(tree, dict):
        return tree.items()
    return ((str(i), v) for i, v in enumerate(tree))


def _walk(tree: tp.Any, path: tuple = ()):
    if isinstance(tree, (dict, list)):
        for k, v in _items(tree):
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _map_leaves(tree: tp.Any, fn, path: tuple = ()):
    """Structure-preserving leaf transform over dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_at(tree, path: tuple):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def gc_stale_tmp(directory: str, tag: str = "",
                 older_than_s: float = STALE_TMP_AGE_S) -> list[str]:
    """Remove ``{tag}checkpoint_*.ckpt.tmp.r*`` staging files older than
    ``older_than_s`` (a killed writer's); a live writer's younger file is
    kept.  Returns the removed paths."""
    removed: list[str] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    now = time.time()
    for name in names:
        if tag and not name.startswith(tag):
            continue
        if not _TMP_RE.match(name[len(tag):]):
            continue
        path = os.path.join(directory, name)
        try:
            if now - os.path.getmtime(path) > older_than_s:
                os.remove(path)
                removed.append(path)
        except OSError:
            continue  # raced another reader, or the writer's rename
    return removed


def _rank_files(directory: str, tag: str) -> dict[int, list[tuple[int, str]]]:
    """``{world: [(rank, path), ...]}`` for every checkpoint set found."""
    out: dict[int, list[tuple[int, str]]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if tag and not name.startswith(tag):
            continue
        m = _CKPT_RE.match(name[len(tag):])
        if not m:
            continue
        rank, world = int(m.group(1)), int(m.group(2))
        out.setdefault(world, []).append(
            (rank, os.path.join(directory, name)))
    for files in out.values():
        files.sort()
    return out


def _to_numpy(path: tuple, leaf):
    """A row's leaf as numpy: tensors by their bits, ints as int64."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in (torch.float32, torch.float64, torch.int32,
                              torch.int64, torch.uint8, torch.bool):
            raise ValueError(
                f"checkpoint leaf {'/'.join(path)} is {leaf.dtype}: the "
                "reshard takes fp32 parameters, momentum and push-sum "
                "weights, as the port keeps them")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int64)
    raise ValueError(f"checkpoint leaf {'/'.join(path)}: unexpected "
                     f"{type(leaf).__name__}")


def _load_file(path: str) -> tuple[dict, dict]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(raw, dict) and set(raw) == {"state", "meta"}):
        raise TornCheckpointError(
            f"{path}: not an atomic state+meta checkpoint")
    meta = raw["meta"]
    try:
        meta = json.loads(meta) if isinstance(meta, str) else meta
    except json.JSONDecodeError as e:
        raise CheckpointMetaError(f"{path}: checkpoint meta is not JSON "
                                  f"({e})") from None
    # a hand-copied set may carry a stripped meta: an empty payload is
    # read as {}, required keys are fetched through meta_key
    if meta is None:
        meta = {}
    elif not isinstance(meta, dict):
        raise CheckpointMetaError(
            f"{path}: checkpoint meta must be a mapping or None, got "
            f"{type(meta).__name__}")
    return _map_leaves(raw["state"], _to_numpy), meta


def _stack_rows(rows: list):
    """Rank rows (one file each) stacked leaf by leaf on a new dim 0."""
    ref = rows[0]
    if isinstance(ref, (dict, list)):
        keys = [k for k, _ in _items(ref)]
        for r in rows[1:]:
            if type(r) is not type(ref) or [k for k, _ in _items(r)] != keys:
                raise TornCheckpointError(
                    "rank files of one set differ in structure")
        if isinstance(ref, dict):
            return {k: _stack_rows([r[k] for r in rows]) for k in ref}
        return [_stack_rows([r[i] for r in rows]) for i in range(len(ref))]
    return np.stack(rows)


def load_world_checkpoint(directory: str, tag: str, world: int
                          ) -> tuple[dict, dict, list[str]]:
    """Stack one world's set into ``[world, ...]`` numpy arrays.

    Reads ``{tag}checkpoint_r{r}_n{world}.ckpt`` for every ``r`` in
    ``0 .. world-1``; a set missing a rank's file raises
    :class:`TornCheckpointError` (naming ``--checkpoint_all`` when rank
    0's file stands alone).  Returns ``(state, meta, paths)``, ``meta``
    the newest file's."""
    gc_stale_tmp(directory, tag)
    files = _rank_files(directory, tag).get(world, [])
    if not files:
        raise TornCheckpointError(
            f"no {tag}checkpoint_r*_n{world}.ckpt under {directory}")
    ranks = [r for r, _ in files]
    if ranks != list(range(world)):
        why = (" (rank 0's file alone, as a --checkpoint_all False run "
               "writes it: one rank's row cannot give the consensus "
               "Σx/Σw)" if ranks == [0] else "")
        raise TornCheckpointError(
            f"torn checkpoint set for world {world}: files "
            f"{[os.path.basename(p) for _, p in files]} hold ranks "
            f"{ranks}, want 0..{world - 1}{why}")
    states, metas = [], []
    for _, path in files:
        state, meta = _load_file(path)
        states.append(state)
        metas.append((os.path.getmtime(path), meta))
    state = _stack_rows(states)
    return state, max(metas, key=lambda m: m[0])[1], [p for _, p in files]


def _ps_weight(state: dict) -> np.ndarray:
    gossip = state.get("gossip")
    if not isinstance(gossip, dict) or "ps_weight" not in gossip:
        raise ValueError("state has no gossip/ps_weight leaf; only the "
                         "gossip TrainState layout is reshardable")
    return np.asarray(gossip["ps_weight"], np.float64).reshape(-1)


def _in_flight_slots(state: dict) -> list[tuple[dict, np.ndarray]]:
    """The overlap FIFO's slots as ``(params, ps_weight rows)`` pairs,
    ``[]`` for a sync run: network mass the collapse counts once."""
    fifo = state.get("gossip", {}).get("in_flight")
    if fifo is None or len(fifo) == 0:
        return []
    if not isinstance(fifo, (list, tuple)):
        raise ValueError(
            "unrecognized gossip/in_flight layout: expected the "
            "serialized overlap FIFO of (params, ps_weight) slots; "
            "these in-flight shares cannot be drained into the "
            "consensus")
    slots = []
    for key, slot in enumerate(fifo):
        if not (isinstance(slot, dict)
                and set(slot) == {"params", "ps_weight"}):
            raise ValueError(
                f"in-flight slot {key} is not a (params, ps_weight) "
                "pair; this FIFO cannot be drained into the consensus")
        w = np.asarray(slot["ps_weight"], np.float64).reshape(-1)
        if not np.all(np.isfinite(w)) or np.any(w < 0):
            raise ValueError(
                f"in-flight slot {key} carries non-finite or negative "
                f"ps-weight mass {w}; refusing to fold it into the "
                "consensus")
        slots.append((slot["params"], w))
    return slots


def consensus_mean(state: dict) -> dict:
    """Per-parameter exact consensus in float64: ``(Σ rank rows + Σ
    in-flight shares) / (Σ ps_weight + Σ in-flight weight)``."""
    slots = _in_flight_slots(state)
    w_sum = (float(_ps_weight(state).sum())
             + sum(float(w.sum()) for _, w in slots))
    out = {}
    for path, leaf in _walk(state["params"]):
        num = np.asarray(leaf, np.float64).sum(0)
        for slot_params, _ in slots:
            num = num + np.asarray(_leaf_at(slot_params, path),
                                   np.float64).sum(0)
        out["/".join(path)] = num / w_sum
    return out


def reshard_state(state: dict, old_world: int, new_world: int) -> dict:
    """Collapse-and-restack a stacked ``[old_world, ...]`` state to
    ``[new_world, ...]``.  Leaf rules (the reference's):

    * ``params/*``: ``Σ rows / Σ ps_weight`` with the in-flight slots
      folded in once (float64, cast back to the leaf dtype), replicated;
    * ``gossip/ps_weight``: 1; ``gossip/phase``: 0;
    * ``gossip/in_flight``: folded above, zero slots at the new world;
    * ``gossip/ef_residual``: zeros (pending quantization correction,
      not network mass: a forfeit bounded by one quantization step);
    * other float leaves (momentum, BatchNorm statistics): the rank
      mean, replicated; integer leaves (``step``): row 0, replicated.
    """
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    slots = _in_flight_slots(state)
    w = _ps_weight(state)
    if w.shape[0] != old_world:
        raise ValueError(f"state holds {w.shape[0]} rank rows, "
                         f"expected old_world={old_world}")
    if not np.all(np.isfinite(w)) or np.any(w <= 0):
        raise ValueError(f"ps_weight must be finite and positive to "
                         f"de-bias the consensus; got {w}")
    w_sum = float(w.sum()) + sum(float(sw.sum()) for _, sw in slots)

    def restack(row: np.ndarray, dtype) -> np.ndarray:
        return np.broadcast_to(
            np.asarray(row, dtype)[None],
            (new_world,) + np.shape(row)).copy()

    def leaf_fn(path, leaf):
        arr = np.asarray(leaf)
        if path == ("gossip", "ps_weight"):
            return np.ones(new_world, arr.dtype)
        if path == ("gossip", "phase"):
            return np.zeros(new_world, arr.dtype)
        if path[:2] in (("gossip", "in_flight"), ("gossip", "ef_residual")):
            return np.zeros((new_world,) + arr.shape[1:], arr.dtype)
        if path and path[0] == "params":
            num = np.asarray(arr, np.float64).sum(0)
            for slot_params, _ in slots:
                num = num + np.asarray(
                    _leaf_at(slot_params, path[1:]), np.float64).sum(0)
            return restack(num / w_sum, arr.dtype)
        if np.issubdtype(arr.dtype, np.floating):
            return restack(np.asarray(arr, np.float64).mean(0), arr.dtype)
        return restack(arr[0], arr.dtype)

    return _map_leaves(state, leaf_fn)


@dataclasses.dataclass(frozen=True)
class ReshardReport:
    """Provenance of one reshard, stamped into the new files' meta."""

    old_world: int
    new_world: int
    mean_drift: float        # max |consensus before - after| over leaves
    ps_mass_err: float       # |Σ old ps_weight / old_world - 1|
    files_in: tuple[str, ...]
    files_out: tuple[str, ...]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["files_in"] = [os.path.basename(p) for p in self.files_in]
        d["files_out"] = [os.path.basename(p) for p in self.files_out]
        return d


def _row_of(state: dict, j: int) -> dict:
    """Row ``j`` of a stacked state in the rank-file layout: CPU tensors,
    ``step`` and ``phase`` as ints."""
    def leaf(path, arr):
        if path in (("step",), ("gossip", "phase")):
            return int(arr[j])
        return torch.from_numpy(np.array(arr[j]))
    return _map_leaves(state, leaf)


def _write_atomic(path: str, payload: dict, rank: int) -> None:
    tmp = path + f".tmp.r{rank}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        # the rename is durable only once the data is on disk
        os.fsync(f.fileno())
    os.replace(tmp, path)


def reshard_checkpoints(directory: str, tag: str, old_world: int,
                        new_world: int, ranks=None, plan: dict | None = None,
                        extra_meta: dict | None = None) -> ReshardReport:
    """Reshard the ``old_world`` set on disk and write the rank files
    ``ranks`` (default every rank of ``new_world``) of the new set.

    Under ``torchrun`` each process passes its own ranks: the write is
    deterministic and atomic, so concurrent callers compose.  The meta
    (epoch, itr, step, best metric) carries over from the old set's
    newest file, without ``health``, with ``reshard`` and ``plan``."""
    state, meta, files_in = load_world_checkpoint(directory, tag, old_world)
    before = consensus_mean(state)
    w = _ps_weight(state)
    new_state = reshard_state(state, old_world, new_world)
    after = consensus_mean(new_state)
    drift = max((float(np.abs(before[k] - after[k]).max())
                 for k in before), default=0.0)

    meta = dict(meta)
    meta.pop("health", None)  # the old world's consensus telemetry
    report = ReshardReport(
        old_world=old_world, new_world=new_world, mean_drift=drift,
        ps_mass_err=abs(float(w.sum()) / old_world - 1.0),
        files_in=tuple(files_in), files_out=())
    meta["reshard"] = report.to_dict()
    if plan is not None:
        meta["plan"] = plan
    if extra_meta:
        meta.update(extra_meta)
    meta_text = json.dumps(meta, default=float)
    out = []
    for r in range(new_world) if ranks is None else ranks:
        path = os.path.join(directory,
                            f"{tag}checkpoint_r{r}_n{new_world}.ckpt")
        _write_atomic(path, {"state": _row_of(new_state, r),
                             "meta": meta_text}, r)
        out.append(path)
    return dataclasses.replace(report, files_out=tuple(out))


def maybe_cross_world_reshard(directory: str, tag: str, world: int,
                              ranks=None, log=None,
                              exact_checked: bool = False
                              ) -> ReshardReport | None:
    """Resume helper for a resized relaunch: with no ``n{world}`` set on
    disk, reshard the newest usable set of another world into place and
    return its report; None when there is no other set.

    Sets are tried newest first and an unusable one (torn, or refused by
    the leaf rules) is skipped with a warning.  Where the reference then
    cold-starts, this raises :class:`TornCheckpointError` naming every
    set and why, so a run never starts over in silence.
    ``exact_checked``: the caller already found (under ``torchrun``, all
    processes together) that no ``n{world}`` file is on disk; the check
    is skipped here because another process's reshard may since have
    written one."""
    gc_stale_tmp(directory, tag)
    sets = _rank_files(directory, tag)
    if world in sets:
        if not exact_checked:
            return None  # an exact-world set exists; normal restore wins
        del sets[world]
    by_age = sorted(sets, key=lambda w: max(os.path.getmtime(p)
                                            for _, p in sets[w]),
                    reverse=True)
    unusable = []
    for old_world in by_age:
        try:
            report = reshard_checkpoints(directory, tag, old_world, world,
                                         ranks=ranks)
        except (TornCheckpointError, ValueError) as e:
            if log is not None:
                log.warning("cross-world resume: world-%d set unusable "
                            "(%s); trying older sets", old_world, e)
            unusable.append(f"world {old_world}: {e}")
            continue
        if log is not None:
            log.warning(
                "cross-world resume: resharded checkpoint set n=%d -> "
                "n=%d (consensus collapse; mean drift %.2e); wrote %s",
                old_world, world, report.mean_drift,
                ", ".join(report.to_dict()["files_out"]))
        return report
    if unusable:
        raise TornCheckpointError(
            f"cross-world resume: no checkpoint set under {directory} can "
            f"be resharded to world {world}: " + "; ".join(unusable))
    return None
