"""AllReduce, Stochastic Gradient Push synchronous (SGP) and overlap
(OSGP), D-PSGD (``PushPullGossip``) and synchronous AD-PSGD
(``BilateralGossip``).

Port of ``AllReduce``, ``PushSumGossip``, ``PushPullGossip``,
``BilateralGossip``, ``drain_in_flight`` and ``drain_state`` in
``stochastic_gradient_push_tpu/algorithms/algorithms.py``, with the
``all_reduce``, ``sgp``, ``osgp``, ``dpsgd`` and ``adpsgd`` factories.
Where the reference takes a mesh axis name, the port takes a transport
(``parallel/collectives.py``).  ``gossip_kernel`` (``"xla"``,
``"auto"``, ``"pallas"`` or a resolved ``KernelLane``) moves the payload
through the gossip transport kernels (``ops/gossip_kernel.py``) in
``gossip_buckets`` buckets, on the stacked transport.
``gossip_every`` thins the rounds and ``global_avg_every`` interleaves
an exact global average (:meth:`PushSumGossip.global_average`).
``faults`` (``resilience/faults.py``) masks the rounds and
``error_feedback`` carries each round's quantization error into the
next (``GossipState.ef_residual``).

A hierarchical schedule runs SGP and OSGP (the delegate share deferred,
the intra-slice mean run at consume); a synthesized one runs SGP.  Both
refuse fault injection, synthesized refuses overlap, D-PSGD refuses both
(irregular), and bilateral pairing refuses both graphs, as the reference
does.

Not ported yet, and refused by name: the kernel lane under
``torch.distributed`` (the cross-process transport kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.gossip_kernel import resolve_gossip_kernel
from ..parallel import collectives
from ..topology.hierarchical import HierarchicalSchedule
from ..topology.schedule import GossipSchedule
from ..topology.synthesized import SynthesizedSchedule
from .api import GossipAlgorithm, GossipState

__all__ = ["AllReduce", "PushSumGossip", "PushPullGossip",
           "BilateralGossip", "all_reduce", "sgp", "osgp", "dpsgd", "adpsgd",
           "drain_in_flight", "drain_state"]


def drain_in_flight(params: dict, ps_weight: torch.Tensor, in_flight):
    """Fold every overlap in-flight share into ``(params, ps_weight)``
    and return the FIFO as zero slots: purely per-rank adds, each pending
    share counted exactly once.  Slots are plain ``(params, ps_weight)``
    pairs (the FIFO between steps).  Returns ``(params, ps_weight,
    drained_fifo)``."""
    for in_p, in_w in in_flight:
        params = {n: p + in_p[n].to(p.dtype) for n, p in params.items()}
        ps_weight = ps_weight + in_w.reshape(ps_weight.shape)
    drained = tuple(({n: torch.zeros_like(a) for n, a in in_p.items()},
                     torch.zeros_like(in_w)) for in_p, in_w in in_flight)
    return params, ps_weight, drained


def drain_state(state):
    """A train state with its overlap FIFO drained into its params (the
    checkpoint view); a no-op without an in-flight FIFO."""
    fifo = getattr(getattr(state, "gossip", None), "in_flight", None)
    if not fifo:
        return state
    params, ps_weight, drained = drain_in_flight(
        state.params, state.gossip.ps_weight, fifo)
    return dataclasses.replace(
        state, params=params,
        gossip=state.gossip.replace(ps_weight=ps_weight, in_flight=drained))


class AllReduce(GossipAlgorithm):
    """Exact AllReduce-SGD baseline: average gradients every step."""

    name = "ar"

    def __init__(self, transport):
        self.transport = transport

    def reduce_grads(self, grads: dict) -> dict:
        return collectives.allreduce_mean(grads, self.transport)


def _leaves(params: dict, ps_weight: torch.Tensor) -> list:
    return list(params.values()) + [ps_weight]


def _tree(names, leaves) -> tuple[dict, torch.Tensor]:
    return dict(zip(names, leaves[:-1])), leaves[-1]


class PushSumGossip(GossipAlgorithm):
    """Stochastic Gradient Push, synchronous or overlap (SGP / OSGP).

    Synchronous: after the optimizer step, one complete push-sum round
    mixes the parameters (the push-sum numerators) and the push-sum
    weight jointly; the forward sees the de-biased ``params /
    ps_weight``.

    Overlap (OSGP): ``pre_step`` launches round ``t`` at the top of the
    step — keeps the local share ``lo * x`` and puts the incoming share
    in the freed tail slot of the ``staleness``-slot FIFO — and
    ``post_step`` consumes the head slot (launched ``staleness - 1``
    steps earlier) at the bottom.  On the kernel lane the launched slot
    is a ``collectives.PendingShares`` whose start kernels have run;
    ``post_step`` lands it (staleness 1) or settles it into a plain share
    (later slots), so between steps the FIFO holds plain tensors only.

    ``gossip_every`` (communication thinning): a round fires on steps
    with ``phase % gossip_every == 0``, at rotation ``phase //
    gossip_every``, so the graph cycles through the peer sequence of
    un-thinned gossip.  A synchronous non-firing step passes the state
    through.  An overlap non-firing step launches nothing and puts a
    zero share in the FIFO tail, so the consume clock stays uniform.
    The reference's skip arm hands ``lax.cond`` a zero transport handle
    on the kernel lane; here the phase is a host int and the FIFO holds
    plain slots beside ``PendingShares``, so the zero share is a plain
    zero ``(params, ps_weight)`` slot on every lane: a skipped step
    launches no kernel at all.

    ``global_avg_every`` (periodic global averaging, 0 = off): after
    the step whose ``phase + 1`` is a multiple of it, every rank takes
    :meth:`global_average`; under overlap after the FIFO's settle, and
    the average folds the FIFO in and leaves it drained.

    ``faults`` (a ``resilience.faults.FaultMasks`` built for this
    ``gossip_every``) masks every round with the rows of its tick: the
    step clock (the launch tick under overlap), so a fault window counts
    wall steps whatever the rotation.  ``error_feedback`` (a lossy
    ``wire``) keeps ``GossipState.ef_residual``: each round sends ``Q(w_0
    x + r)`` and keeps the error; an idle (thinned) step and a global
    average leave the residual as it is.

    ``track_weight=False`` (D-PSGD's synchronous rounds,
    :class:`PushPullGossip`): a synchronous round mixes the parameters
    alone (``collectives.mix_push_pull``), the weight stays 1 and the
    forward sees the parameters undivided.  The overlap split always
    carries the weight, since it scales the parameters by ``lo`` between
    launch and consume.
    """

    name = "sgp"

    def __init__(self, schedule: GossipSchedule, transport,
                 overlap: bool = False, track_weight: bool = True,
                 gossip_every: int = 1,
                 staleness: int = 1, global_avg_every: int = 0,
                 faults=None, wire=None, error_feedback: bool = False,
                 gossip_kernel=None, gossip_buckets: int = 1):
        if isinstance(schedule, HierarchicalSchedule) and faults is not None:
            # the intra-slice mean has no per-edge mask; overlap composes
            # (the delegate share defers, the mean runs at consume)
            raise ValueError(
                "inject_faults is not supported on hierarchical "
                "schedules: the intra-slice psum has no per-edge "
                "mask (use a flat topology for fault drills)")
        if isinstance(schedule, SynthesizedSchedule):
            if faults is not None:
                raise ValueError(
                    "inject_faults is not supported on synthesized "
                    "schedules: grouped psum phases have no per-edge "
                    "mask (use a flat registry topology for fault "
                    "drills)")
            if overlap:
                raise ValueError(
                    "overlap is not supported on synthesized "
                    "schedules: a psum/ppermute phase composition has "
                    "no single augmented in-flight form (use a "
                    "registry topology for overlap runs)")
        if faults is not None and faults.gossip_every != gossip_every:
            # fault rows are resolved against the rotation active at each
            # tick, which depends on thinning
            raise ValueError(
                f"fault masks were compiled for gossip_every="
                f"{faults.gossip_every} but the algorithm runs "
                f"gossip_every={gossip_every}; rebuild the masks with "
                "the matching thinning factor")
        if error_feedback:
            if wire is None or not wire.lossy:
                raise ValueError(
                    "error_feedback needs a lossy wire codec "
                    "(wire_dtype bf16/int8); exact wires have no "
                    "quantization error to feed back")
            if not track_weight:
                raise ValueError(
                    "error_feedback rides the push-sum wire "
                    "(track_weight=True); the push-pull path carries "
                    "no residual state")
        if staleness < 1:
            raise ValueError("staleness must be >= 1")
        if staleness > 1 and not overlap:
            raise ValueError("staleness is an overlap-mode knob")
        if gossip_buckets < 1:
            raise ValueError("gossip_buckets must be >= 1")
        if gossip_every < 1:
            raise ValueError("gossip_every must be >= 1")
        if global_avg_every < 0:
            raise ValueError("global_avg_every must be >= 0")
        # resolved at construction, so "pallas" without a card fails here
        # with the typed KernelBackendError before any step runs
        lane = resolve_gossip_kernel(gossip_kernel)
        if lane is not None and not isinstance(
                transport, collectives.StackedTransport):
            raise NotImplementedError(
                "gossip_kernel='pallas' under a DistTransport: the "
                "cross-process gossip_edge_start (one rank per GPU) is not "
                "ported to stochastic_gradient_push_torch yet (ROADMAP.md "
                "Queue 2); use gossip_kernel='xla' under torch.distributed")
        self.schedule = schedule
        self.transport = transport
        self.overlap = bool(overlap)
        self.track_weight = bool(track_weight)
        self.staleness = int(staleness)
        self.gossip_every = int(gossip_every)
        self.global_avg_every = int(global_avg_every)
        self.wire = wire
        self.faults = faults
        self.error_feedback = bool(error_feedback)
        self.gossip_kernel = lane
        self.gossip_buckets = int(gossip_buckets)
        self.layout = None

    @property
    def transport_kernel_name(self) -> str:
        """The transport lane the wire actually runs: ``"xla"`` without a
        kernel lane or for a lossy codec with no in-kernel decode."""
        if self.gossip_kernel is None:
            return "xla"
        if (self.wire is not None and self.wire.lossy
                and self.wire.kernel_spec() is None):
            return "xla"
        return self.gossip_kernel.name

    def bind_layout(self, layout) -> None:
        """Keep the model's reference layout: the int8 wire blocks each
        leaf as the reference does."""
        self.layout = layout

    def init(self, params: dict) -> GossipState:
        state = super().init(params)
        if self.error_feedback:
            # pending quantization error starts at zero; it mirrors the
            # params, never the ps-weight
            state = state.replace(ef_residual={
                n: torch.zeros_like(p) for n, p in params.items()})
        if self.overlap:
            state = state.replace(in_flight=tuple(
                self._zero_share(params, state.ps_weight)
                for _ in range(self.staleness)))
        return state

    def _round_args(self):
        return dict(codec=self.wire, kernel=self.gossip_kernel,
                    buckets=self.gossip_buckets)

    def _perms(self, names):
        return collectives._leaf_perms(names, self.layout, 1)

    def _mix(self, params: dict, ps_weight, rotation: int, tick: int,
             residual):
        """One synchronous round: ``(params, ps_weight, residual)``."""
        if not self.track_weight:
            return collectives.mix_push_pull(
                params, rotation, self.schedule, self.transport,
                layout=self.layout, **self._round_args()), ps_weight, None
        out = collectives.mix_push_sum(
            params, ps_weight, rotation, self.schedule, self.transport,
            faults=self.faults, tick=tick, ef_residual=residual,
            layout=self.layout, **self._round_args())
        return out if residual is not None else (*out, None)

    def _zero_share(self, params: dict, ps_weight: torch.Tensor):
        return ({n: torch.zeros_like(p) for n, p in params.items()},
                torch.zeros_like(ps_weight))

    def pre_step(self, params: dict, state: GossipState):
        if not self.overlap:
            return params, state
        tick = state.phase
        if tick % self.gossip_every:
            # non-firing step: nothing launches, a plain zero share rides
            # the FIFO
            return params, state.replace(
                in_flight=state.in_flight[:-1]
                + (self._zero_share(params, state.ps_weight),))
        names = list(params)
        res = state.ef_residual
        out = collectives.overlap_launch(
            _leaves(params, state.ps_weight), tick // self.gossip_every,
            self.schedule, self.transport, faults=self.faults, tick=tick,
            ef_residual=(None if res is None else _leaves(
                res, torch.zeros_like(state.ps_weight))),
            perms=self._perms(names), **self._round_args())
        local, incoming = out[0], out[1]
        if res is not None:
            res = _tree(names, out[2])[0]
        if not isinstance(incoming, collectives.PendingShares):
            incoming = _tree(names, incoming)
        params, ps_weight = _tree(names, local)
        return params, state.replace(
            ps_weight=ps_weight, ef_residual=res,
            in_flight=state.in_flight[:-1] + (incoming,))

    def eval_params(self, params: dict, state: GossipState) -> dict:
        if not self.track_weight:
            return params
        w = state.ps_weight
        return {n: p / w.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
                for n, p in params.items()}

    def val_params(self, params: dict, state: GossipState) -> dict:
        """Validation view: every in-flight share drained first, then
        de-biased; the training state is untouched."""
        if not self.overlap:
            return self.eval_params(params, state)
        params, ps_weight, _ = drain_in_flight(params, state.ps_weight,
                                               state.in_flight)
        return self.eval_params(params, state.replace(ps_weight=ps_weight))

    def post_step(self, params: dict, state: GossipState):
        tick = state.phase
        if not self.overlap:
            ps_weight, res = state.ps_weight, state.ef_residual
            if tick % self.gossip_every == 0:
                # an idle step keeps the residual pending
                params, ps_weight, res = self._mix(
                    params, ps_weight, tick // self.gossip_every, tick, res)
            if self._averages_after(tick):
                params, ps_weight = self.global_average(params, ps_weight)
            return params, state.replace(phase=tick + 1,
                                         ps_weight=ps_weight,
                                         ef_residual=res)
        names = list(params)
        head = state.in_flight[0]
        if not isinstance(head, collectives.PendingShares):
            head = [head[0][n] for n in names] + [head[1]]
        leaves = collectives.land_shares(_leaves(params, state.ps_weight),
                                         head)
        if isinstance(self.schedule, HierarchicalSchedule):
            # the consumed share was the delegate half of the round
            # launched staleness - 1 steps ago: its intra-slice mean runs
            # now, when that launch fired, as often as the sync round's
            launch = tick - (self.staleness - 1)
            if launch >= 0 and launch % self.gossip_every == 0:
                leaves = collectives.intra_average(leaves, self.schedule,
                                                   self.transport)
        params, ps_weight = _tree(names, leaves)
        # settle every slot this step does not consume: a live transport
        # handle never outlives the step that launched it
        settled = []
        for slot in state.in_flight[1:]:
            if isinstance(slot, collectives.PendingShares):
                slot = _tree(names, collectives.settle_share(slot))
            settled.append(slot)
        in_flight = tuple(settled) + (self._zero_share(params, ps_weight),)
        if self._averages_after(tick):
            params, ps_weight, in_flight = self.global_average(
                params, ps_weight, in_flight=in_flight)
        return params, state.replace(phase=tick + 1, ps_weight=ps_weight,
                                     in_flight=in_flight)

    def _averages_after(self, tick: int) -> bool:
        """Whether the step at ``tick`` ends in a global average."""
        return (self.global_avg_every > 0
                and (tick + 1) % self.global_avg_every == 0)

    def global_average(self, params: dict, ps_weight: torch.Tensor,
                       in_flight=None):
        """Exact push-sum consensus now: ``x <- sum(params) /
        sum(ps_weight)`` over every rank (``transport.allreduce_sum``),
        and the weight resets to 1.  Mass conservation makes that ratio
        the true parameter average under any column-stochastic mixing.

        ``in_flight`` (the overlap FIFO, plain slots) is folded into
        both sums first (:func:`drain_in_flight`: each pending share
        counted exactly once) and returned drained.  Returns ``(params,
        ps_weight)``, or ``(params, ps_weight, drained_fifo)`` with
        ``in_flight``."""
        drained = None
        if in_flight is not None:
            params, ps_weight, drained = drain_in_flight(params, ps_weight,
                                                         in_flight)
        tot_w = self.transport.allreduce_sum(ps_weight)
        params = {n: self.transport.allreduce_sum(p)
                  / tot_w.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
                  for n, p in params.items()}
        ps_weight = torch.ones_like(ps_weight)
        if drained is None:
            return params, ps_weight
        return params, ps_weight, drained


class PushPullGossip(PushSumGossip):
    """D-PSGD: doubly-stochastic gossip.

    Synchronous mode needs no push-sum weight: a complete doubly-
    stochastic round keeps the mean (``collectives.mix_push_pull``).
    Overlap mode tracks it, as the reference does: the parameters are
    scaled by ``lo`` between launching a round and consuming it, and the
    de-bias keeps the gradient at the right point.  An irregular schedule
    and fault injection are refused as the reference refuses them.
    """

    name = "dpsgd"

    def __init__(self, schedule: GossipSchedule, transport,
                 overlap: bool = False, staleness: int = 1,
                 global_avg_every: int = 0, faults=None,
                 gossip_kernel=None, gossip_buckets: int = 1):
        if not schedule.regular:
            raise ValueError("D-PSGD requires a regular schedule "
                             "(doubly-stochastic mixing)")
        if faults is not None:
            raise ValueError(
                "inject_faults requires push-sum: D-PSGD's "
                "doubly-stochastic invariant does not survive dropped "
                "edges (use --push_sum True)")
        super().__init__(schedule, transport, overlap=overlap,
                         track_weight=overlap, staleness=staleness,
                         global_avg_every=global_avg_every,
                         gossip_kernel=gossip_kernel,
                         gossip_buckets=gossip_buckets)


class BilateralGossip(GossipAlgorithm):
    """AD-PSGD in its synchronous perfect-matching form: after each
    optimizer step every rank averages its parameters with one rotating
    partner, ``x <- (x + x_partner) * 0.5``
    (``collectives.mix_bilat``), the matchings from
    ``topology.build_pairing_schedule``.  No gossip kernel runs."""

    name = "adpsgd"

    def __init__(self, pairing: np.ndarray, transport):
        self.pairing = np.asarray(pairing)
        self.transport = transport

    def post_step(self, params: dict, state: GossipState):
        params = collectives.mix_bilat(params, state.phase, self.pairing,
                                       self.transport)
        return params, state.replace(phase=state.phase + 1)


def all_reduce(transport) -> AllReduce:
    return AllReduce(transport)


def sgp(schedule: GossipSchedule, transport, **kwargs) -> PushSumGossip:
    return PushSumGossip(schedule, transport, **kwargs)


def osgp(schedule: GossipSchedule, transport, staleness: int = 1,
         gossip_kernel=None, gossip_buckets: int = 1,
         wire=None, faults=None,
         error_feedback: bool = False) -> PushSumGossip:
    return PushSumGossip(schedule, transport, overlap=True,
                         staleness=staleness, wire=wire, faults=faults,
                         error_feedback=error_feedback,
                         gossip_kernel=gossip_kernel,
                         gossip_buckets=gossip_buckets)


def dpsgd(schedule: GossipSchedule, transport, overlap: bool = False,
          staleness: int = 1, global_avg_every: int = 0, faults=None,
          gossip_kernel=None, gossip_buckets: int = 1) -> PushPullGossip:
    return PushPullGossip(schedule, transport, overlap=overlap,
                          staleness=staleness,
                          global_avg_every=global_avg_every, faults=faults,
                          gossip_kernel=gossip_kernel,
                          gossip_buckets=gossip_buckets)


def adpsgd(pairing: np.ndarray, transport) -> BilateralGossip:
    return BilateralGossip(pairing, transport)
