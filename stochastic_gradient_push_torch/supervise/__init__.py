"""Restart-boundary tools over a run's checkpoint sets (port of
``stochastic_gradient_push_tpu/supervise/reshard.py``; the reference's
supervisor, fleet and chaos tools are not ported)."""

from .reshard import (CheckpointMetaError, ReshardReport, TornCheckpointError,
                      consensus_mean, gc_stale_tmp, load_world_checkpoint,
                      maybe_cross_world_reshard, meta_key,
                      reshard_checkpoints, reshard_state)

__all__ = ["TornCheckpointError", "CheckpointMetaError", "ReshardReport",
           "load_world_checkpoint", "consensus_mean", "meta_key",
           "reshard_state", "reshard_checkpoints",
           "maybe_cross_world_reshard", "gc_stale_tmp"]
