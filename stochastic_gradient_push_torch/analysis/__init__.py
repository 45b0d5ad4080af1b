"""The schedule verifier's numpy part, as the planner uses it: rotation-
cycle spectral gaps (memoized by table fingerprint in a bounded LRU),
the SGPV table checks and the unsupported-configuration predicate.

A copy of what ``stochastic_gradient_push_tpu/analysis/verifier.py``
gives its planner.  The reference's AST engines check JAX idioms and
have no counterpart here."""

from .findings import Finding
from .verifier import (
    SPARSE_GAP_WORLD_MIN,
    is_unsupported_config,
    schedule_fingerprint,
    spectral_gap,
    spectral_gap_cache_clear,
    spectral_gap_cache_info,
    spectral_gap_cache_limit,
    verify_pairing,
    verify_schedule,
)

__all__ = [
    "Finding",
    "SPARSE_GAP_WORLD_MIN",
    "is_unsupported_config",
    "schedule_fingerprint",
    "spectral_gap",
    "spectral_gap_cache_clear",
    "spectral_gap_cache_info",
    "spectral_gap_cache_limit",
    "verify_pairing",
    "verify_schedule",
]
