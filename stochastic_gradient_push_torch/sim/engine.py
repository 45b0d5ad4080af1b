"""Exact push-sum mixing over compiled schedule tables, in numpy.

Port of ``stochastic_gradient_push_tpu/sim/engine.py``, statement for
statement: on the same schedule tables its states are bit-equal to the
reference's.  The engine executes the SAME per-phase tables the
collective layer's rounds use and ``analysis.verify_schedule``
checks — ``perms`` (destination permutations), ``self_weight`` and
``edge_weights`` — via collision-free fancy-index scatters.  One tick is
one gossip round: phase ``tick % num_phases`` of the rotation.

Exactness contract: for a fault-free tick the scatter is *bit-identical*
to applying the dense mixing matrix decomposed into its permutation
terms (:func:`oracle_tick`) — each dense term ``P_i @ (w_i · x)`` is a
pure row reorder of an elementwise product, so both paths perform the
same float ops in the same order.  The selftest pins this with
``np.array_equal`` at world 256; it is what "the simulator runs the real
schedule" means, as opposed to integrating a convergence-rate formula.

Faults compose through :meth:`~..resilience.faults.FaultPlan.
host_tables` keep/corrupt rows with the collective layer's
mass-conserving semantics: a dropped out-edge's mixing weight is
reabsorbed into the sender's self weight (column sums stay exactly 1,
so ``Σ params / Σ ps_weight`` remains the true network mean under any
fault plan), and a NaN-corrupted sender poisons its outgoing *payloads*
while the push-sum weight lane stays finite.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SimState", "init_state", "gossip_tick", "oracle_tick",
           "consensus", "consensus_error", "run_gossip"]

# per-rank parameter vector width (matches supervise/hostsim.py, so the
# fleet lane's checkpoint trees and the engine agree on shapes)
DEFAULT_DIM = 16


@dataclasses.dataclass
class SimState:
    """One simulated world: de-biased params live in ``params /
    ps_weight`` (push-sum); ``tick`` counts gossip rounds."""

    params: np.ndarray      # (world, d) float64
    ps_weight: np.ndarray   # (world,) float64
    tick: int = 0

    @property
    def world(self) -> int:
        return int(self.params.shape[0])


def init_state(world: int, d: int = DEFAULT_DIM, seed: int = 0,
               rank_offset: int = 0) -> SimState:
    """Per-rank deterministic init, same stream family as the hostsim
    trainer (seed · 100_003 + rank): rank ``r``'s vector never depends
    on the world size, so a grown world's incumbents keep their values.
    """
    params = np.stack([
        np.random.default_rng(seed * 100_003 + rank_offset + r)
        .standard_normal(d)
        for r in range(world)]).astype(np.float64)
    return SimState(params=params, ps_weight=np.ones(world, np.float64))


def _scatter(perms_p, lo, edge_w, x):
    """``out = diag(lo)·x + Σ_i P_i·(edge_w_i · x)`` via collision-free
    scatters (each perm row is a bijection, SGPV101), for ``x`` of shape
    ``(world,)`` or ``(world, d)``."""
    cols = (slice(None), None) if x.ndim == 2 else slice(None)
    out = lo[cols] * x
    for i in range(perms_p.shape[0]):
        out[perms_p[i]] += edge_w[i][cols] * x
    return out


def gossip_tick(state: SimState, schedule, keep_row=None,
                corrupt_row=None) -> SimState:
    """Advance one gossip round (phase ``tick % num_phases``).

    ``keep_row`` — optional ``(ppi, world)`` float mask from
    :meth:`FaultPlan.host_tables`: weight of every masked edge is
    reabsorbed into the sender's self weight (mass-conserving drops).
    ``corrupt_row`` — optional ``(world,)`` mask: NaN-poisoned senders'
    param payloads; their ps_weight lane stays finite.
    """
    p = state.tick % schedule.num_phases
    perms_p = np.asarray(schedule.perms[p])
    self_w = np.asarray(schedule.self_weight[p], np.float64)
    edge_w = np.asarray(schedule.edge_weights[p], np.float64)
    if keep_row is None:
        lo, shipped = self_w, edge_w
    else:
        k = np.asarray(keep_row, np.float64)
        shipped = edge_w * k
        lo = self_w + (edge_w * (1.0 - k)).sum(axis=0)
    if corrupt_row is not None and np.any(np.asarray(corrupt_row) > 0):
        # poisoned senders: the edge terms ship NaN payloads while the
        # self term keeps the rank's own finite copy — only the WIRE is
        # poisoned, matching the collective layer's corrupt_at
        poisoned = np.where(np.asarray(corrupt_row)[:, None] > 0.0,
                            np.nan, state.params)
        params = lo[:, None] * state.params
        for i in range(perms_p.shape[0]):
            params[perms_p[i]] += shipped[i][:, None] * poisoned
    else:
        params = _scatter(perms_p, lo, shipped, state.params)
    ps = _scatter(perms_p, lo, shipped, state.ps_weight)
    return SimState(params=params, ps_weight=ps, tick=state.tick + 1)


def oracle_tick(state: SimState, schedule) -> SimState:
    """The independent dense oracle for a fault-free tick: the mixing
    matrix applied term by term — ``diag(self_w)·x`` plus one dense
    permutation-matrix product per sub-round.  A permutation matrix row
    has a single 1.0, so ``P_i @ v`` reorders ``v`` without arithmetic;
    the float ops and their order are exactly the engine's, which is
    what makes ``np.array_equal`` (not allclose) the right assertion.
    """
    p = state.tick % schedule.num_phases
    n = schedule.world_size
    self_w = np.asarray(schedule.self_weight[p], np.float64)
    params = self_w[:, None] * state.params
    ps = self_w * state.ps_weight
    for i in range(schedule.peers_per_itr):
        pm = np.zeros((n, n), np.float64)
        pm[np.asarray(schedule.perms[p, i]), np.arange(n)] = 1.0
        w = np.asarray(schedule.edge_weights[p, i], np.float64)
        params += pm @ (w[:, None] * state.params)
        ps += pm @ (w * state.ps_weight)
    return SimState(params=params, ps_weight=ps, tick=state.tick + 1)


def consensus(state: SimState) -> np.ndarray:
    """Per-rank de-biased estimates ``params / ps_weight``, (world, d)."""
    return state.params / state.ps_weight[:, None]


def consensus_error(state: SimState, target: np.ndarray) -> float:
    """Worst-rank sup-norm distance of the de-biased estimates from the
    network mean ``target`` (column-stochastic mixing conserves mass, so
    the target is the initial mean forever, faults included)."""
    return float(np.abs(consensus(state) - target[None]).max())


def run_gossip(schedule, steps: int, d: int = DEFAULT_DIM, seed: int = 0,
               fault_plan=None) -> tuple[SimState, list[float]]:
    """Run ``steps`` gossip rounds from a fresh state; returns the final
    state and the per-tick consensus-error trace.  ``fault_plan``
    (a :class:`~..resilience.faults.FaultPlan`) is compiled once to host
    keep/corrupt tables and indexed per tick."""
    state = init_state(schedule.world_size, d=d, seed=seed)
    target = state.params.mean(axis=0)
    keep = corrupt = None
    horizon = 0
    if fault_plan is not None:
        keep, corrupt, horizon = fault_plan.host_tables(schedule)
    errors = []
    for _ in range(steps):
        keep_row = corrupt_row = None
        if keep is not None:
            row = (state.tick if state.tick < horizon
                   else horizon + state.tick % schedule.num_phases)
            keep_row, corrupt_row = keep[row], corrupt[row]
            if not np.any(corrupt_row):
                corrupt_row = None
        state = gossip_tick(state, schedule, keep_row=keep_row,
                            corrupt_row=corrupt_row)
        errors.append(consensus_error(state, target))
    return state, errors
