"""Checkpoint ingest: a gossip run's per-rank files -> one serving tree.

Port of ``stochastic_gradient_push_tpu/serve/load.py`` (``ConsensusIngest
Error``, ``IngestInfo``, ``available_worlds``, ``load_consensus``).  The
model SGP deploys is not any one rank's parameters but the push-sum
consensus ``x̄ = Σᵢ paramsᵢ / Σᵢ ps_weightᵢ``, the collapse
``supervise/reshard.py::reshard_state`` computes at a restart boundary:

* a torn set is rejected (:class:`~..supervise.reshard.TornCheckpointError`
  propagates; a ``--checkpoint_all False`` set, rank 0's file alone, is
  one);
* the overlap FIFO's in-flight shares are folded into the consensus,
  each counted once;
* an error-feedback residual is dropped (the reshard's bounded forfeit).

:func:`load_consensus` returns the parameters bit-equal to
``reshard_state(state, world, 1)["params"]`` row 0, as fp32 CPU tensors
under the training state's names (``TransformerLM``'s ``state_dict``
names for the LM).  ``LMEngine`` takes the flax-layout tree:
``models/convert.py::params_to_jax`` turns the one into the other::

    params, meta, info = load_consensus(ckpt_dir, tag="lm_")
    engine = LMEngine(params_to_jax(params), ServeConfig(n_heads=12))

The decode placement is the reference's (``decode_partition_rules``,
``match_partition_rules``, ``shard_params_for_decode``, ``:110-184``
there), on the flax-layout tree: the same regexes over the ``/``-joined
paths; ``q``, ``k``, ``v``, ``up`` and ``lm_head`` kernels split on their
output dim, ``o`` and ``down`` on their input dim, every other leaf
replicated, and a dim the shard count does not divide replicated too.  A
spec is the tuple of a ``PartitionSpec`` (``(None, "model")``, ``()``).
Where the reference places the tree on a mesh and GSPMD adds the sums,
:func:`shard_params_for_decode` returns one tree a shard for
``serve/engine.py``'s sharded engine, which adds them itself.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from ..supervise.reshard import (_in_flight_slots, _rank_files,
                                 load_world_checkpoint, reshard_state)

__all__ = ["ConsensusIngestError", "IngestInfo", "available_worlds",
           "load_consensus", "decode_partition_rules",
           "match_partition_rules", "decode_placement",
           "shard_params_for_decode", "MODEL_AXIS"]

MODEL_AXIS = "model"    # the reference's decode mesh axis


class ConsensusIngestError(RuntimeError):
    """No checkpoint set that serving can ingest (an empty directory, or
    a requested world with no files)."""


@dataclasses.dataclass(frozen=True)
class IngestInfo:
    """Provenance of one consensus ingest."""

    world: int
    files: tuple[str, ...]
    step: int | None            # the meta's step, when carried
    in_flight_folded: int       # overlap FIFO slots folded into Σx/Σw
    ef_forfeited: bool          # a nonzero EF residual dropped (bounded)
    plan: dict | None           # the run's schedule, when carried

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["files"] = [os.path.basename(p) for p in self.files]
        d["plan"] = bool(self.plan)
        return d


def available_worlds(directory: str, tag: str = "") -> list[int]:
    """World sizes with a checkpoint set on disk, newest set first."""
    sets = _rank_files(directory, tag)
    return sorted(
        sets, reverse=True,
        key=lambda w: max(os.path.getmtime(p) for _, p in sets[w]))


def load_consensus(directory: str, tag: str = "",
                   world: int | None = None):
    """Ingest one checkpoint set into a single parameter set.

    Returns ``(params, meta, info)``: ``params`` the consensus model as
    ``{name: CPU tensor}`` (bit-equal to the reshard collapse at
    ``new_world=1``), ``meta`` the set's meta, ``info`` an
    :class:`IngestInfo`.  ``world=None`` picks the newest set on disk."""
    if world is None:
        worlds = available_worlds(directory, tag)
        if not worlds:
            raise ConsensusIngestError(
                f"no {tag}checkpoint_r*_n*.ckpt under {directory}")
        world = worlds[0]
    state, meta, paths = load_world_checkpoint(directory, tag, world)
    in_flight = len(_in_flight_slots(state))
    ef = state.get("gossip", {}).get("ef_residual")
    ef_forfeited = bool(ef is not None and any(
        np.any(np.asarray(v, np.float64) != 0.0) for v in ef.values()))
    collapsed = reshard_state(state, world, 1)
    params = {n: torch.from_numpy(np.array(a[0]))
              for n, a in collapsed["params"].items()}
    step = meta.get("step")
    info = IngestInfo(
        world=world, files=tuple(paths),
        step=None if step is None else int(step),
        in_flight_folded=in_flight, ef_forfeited=ef_forfeited,
        plan=meta.get("plan"))
    return params, meta, info


# -- decode placement ----------------------------------------------------------


def decode_partition_rules(axis: str | None = None):
    """Regex over a leaf's ``/``-joined path -> the spec of its placement
    on the 1-D decode axis: q/k/v/up/lm_head split their output (head /
    ff / vocab) dim, o/down their input dim, so each pair stays a
    contraction over the axis; norms, biases and the embedding
    replicate.  First match wins; the catch-all replicates anything a
    later model adds."""
    axis = MODEL_AXIS if axis is None else axis
    return (
        (r"attn/(q|k|v)/kernel$", (None, axis)),
        (r"attn/o/kernel$", (axis, None)),
        (r"up/kernel$", (None, axis)),
        (r"down/kernel$", (axis, None)),
        (r"lm_head/kernel$", (None, axis)),
        (r".*", ()),
    )


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def match_partition_rules(rules, params) -> dict:
    """Every leaf's spec: that of the first rule whose regex searches its
    ``/``-joined path.  Scalar leaves are replicated without the rules; a
    leaf no rule matches is a :class:`ConsensusIngestError`."""

    def leaf_fn(path, leaf):
        if leaf is None:
            return None
        name = "/".join(path)
        if np.ndim(leaf) == 0 or np.size(leaf) == 1:
            return ()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return tuple(spec)
        raise ConsensusIngestError(
            f"no partition rule matches param '{name}'")

    return _map_leaves(params, leaf_fn)


def decode_placement(params, shards: int, rules=None) -> dict:
    """Every leaf's split dim over ``shards`` shards, or None where it is
    replicated: its rule's, or None where ``shards`` does not divide that
    dim (tiny models on wide meshes must still serve)."""
    specs = match_partition_rules(
        decode_partition_rules() if rules is None else rules, params)

    def place(path, leaf):
        if leaf is None:
            return None
        spec = specs
        for k in path:
            spec = spec[k]
        dims = [d for d, axis in enumerate(spec) if axis is not None]
        if shards == 1 or not dims or np.shape(leaf)[dims[0]] % shards:
            return None
        return dims[0]

    return _map_leaves(params, place)


def shard_params_for_decode(params, shards: int, rules=None) -> list:
    """The tree ``shards`` ways: a list of one tree a shard, each leaf its
    shard's contiguous block on the dim :func:`decode_placement` names,
    or the whole leaf where it is replicated."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    dims = decode_placement(params, shards, rules)

    def part(i):
        def take(path, leaf):
            d = dims
            for k in path:
                d = d[k]
            if d is None:
                return leaf
            n = np.shape(leaf)[d] // shards
            idx = [slice(None)] * np.ndim(leaf)
            idx[d] = slice(i * n, (i + 1) * n)
            return leaf[tuple(idx)]
        return _map_leaves(params, take)

    return [part(i) for i in range(shards)]
