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

The reference's decode-mesh placement (``decode_partition_rules``,
``match_partition_rules``, ``shard_params_for_decode``) goes with the
sharded decode and is not ported (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..supervise.reshard import (_in_flight_slots, _rank_files,
                                 load_world_checkpoint, reshard_state)

__all__ = ["ConsensusIngestError", "IngestInfo", "available_worlds",
           "load_consensus"]


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
