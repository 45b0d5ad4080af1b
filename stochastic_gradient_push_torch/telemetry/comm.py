"""Comm-volume accounting: analytic bytes-per-round for the active plan.

A copy of ``stochastic_gradient_push_tpu/telemetry/comm.py``, exact
integer math, whose payload functions walk the port's parameter dicts of
tensors.  It converts the running configuration — topology, mixing
schedule, ``gossip_every`` thinning, ``global_avg_every`` exact
averaging, fault plan, wire codec — into bytes on the wire that sit next
to measured step time:

* :class:`CommModel` — the analytic model.  Pure integer/host math,
  derived once from the :class:`~..topology.schedule.GossipSchedule`
  (plus knobs), then evaluated per step.  All figures are **per-rank
  bytes sent**:

  - *gossip wire*: ``ppi × (payload + 4)`` per fired round — every
    edge of the round is sent (faults only zero the mixing weights), so
    wire bytes are fault-independent; the ``+ 4`` is the push-sum weight
    scalar riding each message.
  - *link lanes*: the wire split by link class.  Every gossip edge is
    classified by the fabric's slice decomposition (the planner's
    ``InterconnectModel.slice_size``, or the schedule's own slices for a
    hierarchical run): same slice → ``gossip_ici``, cross slice →
    ``gossip_dcn``.  The names are the reference's (its report reads
    them); on the card they mean within a slice (NVLink inside a node)
    and across slices (the network between nodes).  Without slice
    structure everything is the first lane.  Hierarchical rounds price
    the delegate messages per edge and the intra-slice grouped mean as a
    ring allreduce inside the slice, ``2·(s−1)/s × payload``.
  - *gossip delivered*: wire bytes × the fault plan's surviving-edge
    fraction at that tick — what actually lands in the mixing sum.
  - *hop-weighted*: wire bytes × the phase's mean ring-hop distance
    (the planner scorer's cost metric, in bytes·hops).
  - *exact averages* (scheduled ``global_avg_every``, reactive
    recovery, or AllReduce-every-step mode): ring-allreduce cost,
    ``2·(n−1)/n × payload`` per rank, not link-classified.

* :class:`CommAccountant` — the running tally the train loop feeds
  (``on_step`` per optimizer step, ``on_recovery`` per reactive
  average); snapshots publish as ``comm`` events through the registry.
  An accountant fed steps ``0..N-1`` reports exactly
  :meth:`CommModel.totals`\\ ``(N)``.

Step/tick convention (as ``algorithms/``): the tick is the 0-based
optimizer-step counter; a gossip round fires when ``tick % gossip_every
== 0`` with rotation phase ``(tick // gossip_every) % num_phases``; the
scheduled exact average fires when ``(tick + 1) % global_avg_every ==
0``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CommModel", "CommAccountant", "tree_payload_bytes",
           "encoded_payload_bytes", "allreduce_bytes", "PS_WEIGHT_BYTES",
           "COMM_CATEGORIES"]

# the push-sum weight scalar that rides along with every gossip payload
PS_WEIGHT_BYTES = 4

# byte categories every snapshot reports (zero-filled when inactive);
# gossip_ici + gossip_dcn == gossip_wire (the wire split by link class)
COMM_CATEGORIES = ("gossip_wire", "gossip_delivered", "gossip_hop_bytes",
                   "gossip_ici", "gossip_dcn",
                   "global_avg", "recovery", "allreduce")


def _leaves(tree):
    """The array leaves of a parameter tree: dicts (in key order),
    lists and tuples walked, ``None`` skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _size_itemsize(leaf) -> tuple[int, int]:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel(), leaf.element_size()
    arr = np.asarray(leaf)
    return int(arr.size), arr.dtype.itemsize


def tree_payload_bytes(params, world: int = 1,
                       itemsize: int | None = None) -> int:
    """Bytes of one rank's full parameter payload.

    ``params`` is a parameter dict of tensors whose leaves stack
    ``world`` ranks on their leading dim: the stacked state's ``[R,
    ...]`` with ``world = R``, or a process's own ``[1, ...]`` block with
    ``world = 1`` (the same number).  Pass ``itemsize`` to price a
    wire-compression dtype (e.g. 2 for bf16 gossip) instead of each
    leaf's storage dtype.
    """
    total = 0
    for leaf in _leaves(params):
        size, isz = _size_itemsize(leaf)
        total += (size // max(1, world)) * (
            itemsize if itemsize is not None else isz)
    return total


def encoded_payload_bytes(params, world: int = 1, codec=None) -> int:
    """Bytes of one rank's payload *as the wire ships it*.

    Leaves with more than one element per rank go through the codec
    (:meth:`~..parallel.wire.WireCodec.element_bytes` — dtype size plus
    the int8 per-block scale lane), while scalar leaves stay at their
    own storage dtype (the collectives' ``size > 1`` guard keeps them
    off the codec).  ``codec=None`` (or the identity codec) is
    :func:`tree_payload_bytes`, the uncompressed wire.  ``world`` as
    there.
    """
    total = 0
    for leaf in _leaves(params):
        size, isz = _size_itemsize(leaf)
        size //= max(1, world)
        if codec is None or size <= 1:
            total += size * isz
        else:
            total += codec.element_bytes(size, isz)
    return total


def allreduce_bytes(payload: int, world: int) -> int:
    """Per-rank bytes sent by one exact average of ``payload`` bytes:
    the bandwidth-optimal ring allreduce ships ``2·(n−1)/n`` of the
    buffer per rank (reduce-scatter + all-gather)."""
    if world <= 1:
        return 0
    return int(round(payload * 2 * (world - 1) / world))


def _ring_hop(src: int, dst: int, world: int) -> int:
    d = (dst - src) % world
    return min(d, world - d)


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Analytic per-step comm cost of one running configuration."""

    mode: str                       # "gossip" | "bilat" | "allreduce"
    world: int
    ppi: int
    num_phases: int
    payload_bytes: int              # gossip wire payload (comm dtype)
    exact_bytes: int                # full-precision payload (exact avgs)
    # per-message overhead: the push-sum weight scalar (0 for D-PSGD /
    # bilateral exchanges, which carry no weight lane)
    msg_overhead_bytes: int = PS_WEIGHT_BYTES
    gossip_every: int = 1
    global_avg_every: int = 0
    hops_per_phase: tuple[float, ...] = ()   # mean hops/message by phase
    # fault keep table (horizon+phases, ppi, world) as nested tuples is
    # unwieldy; store the per-row delivered fraction instead
    keep_fraction_rows: tuple[float, ...] = ()
    keep_horizon: int = 0
    # link-class lanes: fabric slice decomposition classifying each edge
    # (None = one slice, everything ICI) and the resulting per-phase
    # per-rank byte splits — precomputed at construction; for a
    # hierarchical schedule a "phase" is one compiled round (delegate
    # messages + intra-slice grouped allreduce)
    slice_size: int | None = None
    hier: bool = False
    # synthesized composition (topology/synthesized.py): one model phase
    # per compiled round — edge phases priced per real message, psum
    # phases as grouped ring-allreduces (exact payload, no codec)
    synthesized: bool = False
    # wire codec provenance (parallel/wire.py): how payload_bytes was
    # encoded — stamped into snapshots so obsreport names the format
    # behind the byte counts
    wire_dtype: str = "f32"
    wire_block: int | None = None
    error_feedback: bool = False
    # overlap provenance: the double-buffered phase schedule moves the
    # SAME bytes as the sync round (every launched share is one wire
    # round, consumed exactly once) — overlap changes wall-clock, never
    # volume — so these fields only stamp the mode into snapshots
    overlap: bool = False
    staleness: int = 1
    # transport-lane provenance (ops/gossip_kernel.py): "pallas" = the
    # hand-written edge kernels (K2/K1), "xla" = the plain transport.
    # Like overlap, the lane re-times the wire without re-pricing it —
    # bytes on the interconnect are identical by construction — so this
    # only stamps which kernel moved them
    gossip_kernel: str = "xla"
    # kernel-lane pipelining provenance: the payload is partitioned
    # into this many contiguous transport buckets, each its own
    # start/wait kernel program.  A pure partition of the SAME bytes —
    # re-times the wire, never re-prices it — so like the lane it only
    # stamps how the payload was pipelined
    gossip_buckets: int = 1
    wire_bytes_per_phase: tuple[int, ...] = ()
    ici_bytes_per_phase: tuple[int, ...] = ()
    dcn_bytes_per_phase: tuple[int, ...] = ()
    hop_bytes_per_phase: tuple[int, ...] = ()

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_schedule(cls, schedule, payload_bytes: int,
                      exact_bytes: int | None = None,
                      gossip_every: int = 1, global_avg_every: int = 0,
                      faults=None, ps_weight: bool = True,
                      interconnect=None, codec=None,
                      error_feedback: bool = False,
                      overlap: bool = False,
                      staleness: int = 1,
                      gossip_kernel: str = "xla",
                      gossip_buckets: int = 1) -> "CommModel":
        """Model a push-sum/D-PSGD run over ``schedule``.

        ``payload_bytes`` must already be the ENCODED wire payload
        (:func:`encoded_payload_bytes`); ``codec`` only stamps the wire
        format's provenance (dtype/block) into the model so snapshots
        name the encoding behind the numbers.  ``faults`` is an optional
        ``resilience.FaultMasks``; its keep table yields the delivered
        fraction per tick row.  ``ps_weight`` False drops the
        per-message weight scalar (D-PSGD).  ``interconnect`` (a planner
        ``InterconnectModel``) supplies the fabric slice decomposition
        for the ICI/DCN lane split; without one, a hierarchical
        schedule's own slices classify and flat schedules stay
        single-lane ICI.  On a hierarchical schedule only the delegate
        (inter) messages ride the codec — the intra-slice grouped psum
        is exact, which is exactly how the collective layer compiles it.
        ``overlap``/``staleness`` stamp the double-buffered phase
        schedule into snapshots WITHOUT changing any lane: the
        overlapped round launches the identical wire (each share sent
        once, consumed once), so per-step bytes equal sync by
        construction — only wall-clock moves.
        """
        wire_dtype = getattr(codec, "name", "f32") if codec else "f32"
        wire_block = getattr(codec, "block", None) if codec else None
        n = schedule.world_size
        payload = int(payload_bytes)
        exact = int(exact_bytes if exact_bytes is not None
                    else payload_bytes)
        overhead = PS_WEIGHT_BYTES if ps_weight else 0
        msg = payload + overhead
        fabric = getattr(interconnect, "slice_size", None) \
            or getattr(schedule, "slice_size", None)

        def classify(perms, weights, phases, ppi):
            """Per-phase (cross_msgs, same_msgs, hop_sum) over real
            edges (zero-weight padding and loopbacks excluded)."""
            rows = []
            for p in range(phases):
                cross = same = 0
                hop_sum = 0.0
                for i in range(ppi):
                    for src in range(n):
                        if weights[p, i, src] <= 0.0:
                            continue
                        dst = int(perms[p, i, src])
                        if dst == src:
                            continue
                        if fabric and src // fabric != dst // fabric:
                            cross += 1
                        else:
                            same += 1
                        hop_sum += _ring_hop(src, dst, n)
                rows.append((cross, same, hop_sum))
            return rows

        kinds = getattr(schedule, "phase_kinds", None)
        if kinds is not None and "inter" not in kinds:
            # synthesized composition ("edge"/"psum" kinds): one model
            # phase per compiled round.  Edge phases price their real
            # messages (sparse delegate permutations send fewer than
            # one payload per rank); psum phases ship the grouped
            # ring-allreduce 2·(g−1)/g of the EXACT payload per member
            # (the codec never touches a grouped collective).  Lane
            # split by the fabric slice decomposition: a psum whose
            # groups sit inside one slice is ICI, one spanning slices
            # is conservatively all DCN.
            if faults is not None:
                raise ValueError("fault pricing is not supported on "
                                 "synthesized schedules")
            wire_l, ici_l, dcn_l, hop_l = [], [], [], []
            for p, kind in enumerate(kinds):
                if kind == "psum":
                    groups = schedule.phase_groups[p]
                    g = len(groups[0])
                    b = int(round(2.0 * (g - 1) / g * exact))
                    crosses = fabric is not None and any(
                        len({r // fabric for r in grp}) > 1
                        for grp in groups)
                    wire_l.append(b)
                    ici_l.append(0 if crosses else b)
                    dcn_l.append(b if crosses else 0)
                    # grouped collective over contiguous members:
                    # nearest-neighbour, one hop per byte
                    hop_l.append(b)
                else:
                    row = classify(schedule.perms[p:p + 1],
                                   schedule.edge_weights[p:p + 1], 1,
                                   schedule.peers_per_itr)[0]
                    cross, same, hop_sum = row
                    dcn = int(round(cross * msg / n))
                    ici = int(round(same * msg / n))
                    wire_l.append(dcn + ici)
                    ici_l.append(ici)
                    dcn_l.append(dcn)
                    hop_l.append(int(round(hop_sum * msg / n)))
            return cls(mode="gossip", world=n, ppi=1,
                       num_phases=len(kinds),
                       payload_bytes=payload, exact_bytes=exact,
                       msg_overhead_bytes=overhead,
                       gossip_every=max(1, int(gossip_every)),
                       global_avg_every=max(0, int(global_avg_every)),
                       slice_size=fabric, synthesized=True,
                       wire_dtype=wire_dtype, wire_block=wire_block,
                       error_feedback=bool(error_feedback),
                       overlap=bool(overlap),
                       staleness=max(1, int(staleness)),
                       gossip_kernel=str(gossip_kernel),
                       gossip_buckets=max(1, int(gossip_buckets)),
                       wire_bytes_per_phase=tuple(wire_l),
                       ici_bytes_per_phase=tuple(ici_l),
                       dcn_bytes_per_phase=tuple(dcn_l),
                       hop_bytes_per_phase=tuple(hop_l))
        if kinds is not None:
            # hierarchical: one model phase per compiled round
            if faults is not None:
                raise ValueError("fault pricing is not supported on "
                                 "hierarchical schedules")
            inter = schedule.inter_schedule
            s = schedule.slice_size
            intra_bytes = int(round(2.0 * (s - 1) / s * exact))
            wire_l, ici_l, dcn_l, hop_l = [], [], [], []
            for cross, same, hop_sum in classify(
                    inter.perms, inter.edge_weights,
                    schedule.rounds_per_cycle, inter.peers_per_itr):
                dcn = int(round(cross * msg / n))
                ici = int(round(same * msg / n)) + intra_bytes
                wire_l.append(dcn + ici)
                ici_l.append(ici)
                dcn_l.append(dcn)
                # the grouped psum is nearest-neighbour inside the slice:
                # one hop per byte; delegate messages at ring distance
                hop_l.append(int(round(hop_sum * msg / n)) + intra_bytes)
            return cls(mode="gossip", world=n, ppi=schedule.inter_ppi,
                       num_phases=schedule.rounds_per_cycle,
                       payload_bytes=payload, exact_bytes=exact,
                       msg_overhead_bytes=overhead,
                       gossip_every=max(1, int(gossip_every)),
                       global_avg_every=max(0, int(global_avg_every)),
                       slice_size=fabric, hier=True,
                       wire_dtype=wire_dtype, wire_block=wire_block,
                       error_feedback=bool(error_feedback),
                       overlap=bool(overlap),
                       staleness=max(1, int(staleness)),
                       gossip_kernel=str(gossip_kernel),
                       gossip_buckets=max(1, int(gossip_buckets)),
                       wire_bytes_per_phase=tuple(wire_l),
                       ici_bytes_per_phase=tuple(ici_l),
                       dcn_bytes_per_phase=tuple(dcn_l),
                       hop_bytes_per_phase=tuple(hop_l))

        hops = []
        wire_l, ici_l, dcn_l, hop_l = [], [], [], []
        wire = schedule.peers_per_itr * msg
        for cross, same, hop_sum in classify(
                schedule.perms, schedule.edge_weights,
                schedule.num_phases, schedule.peers_per_itr):
            hops.append(hop_sum / max(1, n * schedule.peers_per_itr))
            dcn = int(round(cross * msg / n))
            wire_l.append(wire)
            dcn_l.append(dcn)
            ici_l.append(wire - dcn)
            hop_l.append(int(round(msg * hops[-1])))
        keep_rows: tuple[float, ...] = ()
        horizon = 0
        if faults is not None:
            keep = faults.keep_host()  # (horizon+phases, ppi, world)
            keep_rows = tuple(float(keep[r].mean())
                              for r in range(keep.shape[0]))
            horizon = int(faults.horizon)
        return cls(mode="gossip", world=n, ppi=schedule.peers_per_itr,
                   num_phases=schedule.num_phases,
                   payload_bytes=payload, exact_bytes=exact,
                   msg_overhead_bytes=overhead,
                   gossip_every=max(1, int(gossip_every)),
                   global_avg_every=max(0, int(global_avg_every)),
                   hops_per_phase=tuple(hops),
                   keep_fraction_rows=keep_rows, keep_horizon=horizon,
                   slice_size=fabric,
                   wire_dtype=wire_dtype, wire_block=wire_block,
                   error_feedback=bool(error_feedback),
                   overlap=bool(overlap),
                   staleness=max(1, int(staleness)),
                   gossip_kernel=str(gossip_kernel),
                   gossip_buckets=max(1, int(gossip_buckets)),
                   wire_bytes_per_phase=tuple(wire_l),
                   ici_bytes_per_phase=tuple(ici_l),
                   dcn_bytes_per_phase=tuple(dcn_l),
                   hop_bytes_per_phase=tuple(hop_l))

    @classmethod
    def for_allreduce(cls, world: int, payload_bytes: int) -> "CommModel":
        """Exact AllReduce every step (the baseline SGP competes with)."""
        return cls(mode="allreduce", world=world, ppi=0, num_phases=1,
                   payload_bytes=int(payload_bytes),
                   exact_bytes=int(payload_bytes))

    @classmethod
    def for_bilat(cls, world: int, payload_bytes: int) -> "CommModel":
        """AD-PSGD bilateral averaging: one partner exchange per round
        (per-rank send = one payload; no push-sum weight scalar)."""
        return cls(mode="bilat", world=world, ppi=1, num_phases=1,
                   payload_bytes=int(payload_bytes),
                   exact_bytes=int(payload_bytes),
                   msg_overhead_bytes=0)

    # -- schedule arithmetic ----------------------------------------------

    def gossip_fires(self, step: int) -> bool:
        return self.mode in ("gossip", "bilat") \
            and step % self.gossip_every == 0

    def phase_at(self, step: int) -> int:
        return (step // self.gossip_every) % self.num_phases

    def global_avg_fires(self, step: int) -> bool:
        return (self.mode == "gossip" and self.global_avg_every > 0
                and (step + 1) % self.global_avg_every == 0)

    def delivered_fraction(self, step: int) -> float:
        """Surviving-edge fraction under the fault plan at this tick
        (1.0 without faults); same row logic as FaultMasks._row."""
        if not self.keep_fraction_rows:
            return 1.0
        if step < self.keep_horizon:
            row = step
        else:
            row = self.keep_horizon + self.phase_at(step)
        return self.keep_fraction_rows[row]

    # -- per-step / total bytes -------------------------------------------

    def step_bytes(self, step: int) -> dict:
        """Per-rank bytes sent at optimizer step ``step`` by category."""
        out = dict.fromkeys(COMM_CATEGORIES, 0)
        if self.mode == "allreduce":
            out["allreduce"] = allreduce_bytes(self.exact_bytes, self.world)
            return out
        if self.gossip_fires(step):
            msg = self.payload_bytes + self.msg_overhead_bytes
            if self.wire_bytes_per_phase:
                p = self.phase_at(step)
                wire = self.wire_bytes_per_phase[p]
                out["gossip_wire"] = wire
                out["gossip_ici"] = self.ici_bytes_per_phase[p]
                out["gossip_dcn"] = self.dcn_bytes_per_phase[p]
                out["gossip_hop_bytes"] = self.hop_bytes_per_phase[p]
            else:
                # bilat / hand-built models with no schedule tables: the
                # whole exchange is one fabric (ICI lane by convention)
                wire = self.ppi * msg
                out["gossip_wire"] = out["gossip_ici"] = wire
                hops = (self.hops_per_phase[self.phase_at(step)]
                        if self.hops_per_phase else float(self.ppi))
                out["gossip_hop_bytes"] = int(round(msg * hops))
            out["gossip_delivered"] = int(
                round(wire * self.delivered_fraction(step)))
        if self.global_avg_fires(step):
            out["global_avg"] = allreduce_bytes(self.exact_bytes,
                                                self.world)
        return out

    def recovery_bytes(self) -> int:
        """Per-rank bytes of one reactive exact global average."""
        return allreduce_bytes(self.exact_bytes, self.world)

    def totals(self, num_steps: int, start: int = 0) -> dict:
        """Analytic expectation for steps ``start .. start+num_steps-1``."""
        out = dict.fromkeys(COMM_CATEGORIES, 0)
        for t in range(start, start + num_steps):
            for k, v in self.step_bytes(t).items():
                out[k] += v
        return out

    def to_dict(self) -> dict:
        return {"mode": self.mode, "world": self.world, "ppi": self.ppi,
                "num_phases": self.num_phases,
                "payload_bytes": self.payload_bytes,
                "exact_bytes": self.exact_bytes,
                "msg_overhead_bytes": self.msg_overhead_bytes,
                "gossip_every": self.gossip_every,
                "global_avg_every": self.global_avg_every,
                "hops_per_phase": [round(h, 4)
                                   for h in self.hops_per_phase],
                "faulted": bool(self.keep_fraction_rows),
                "slice_size": self.slice_size,
                "hierarchical": self.hier,
                "synthesized": self.synthesized,
                "wire_dtype": self.wire_dtype,
                "wire_block": self.wire_block,
                "error_feedback": self.error_feedback,
                "overlap": self.overlap,
                "staleness": self.staleness,
                "gossip_kernel": self.gossip_kernel,
                "gossip_buckets": self.gossip_buckets,
                "ici_bytes_per_phase": list(self.ici_bytes_per_phase),
                "dcn_bytes_per_phase": list(self.dcn_bytes_per_phase)}


class CommAccountant:
    """Running per-rank comm tally the train loop feeds step by step."""

    def __init__(self, model: CommModel):
        self.model = model
        self.totals = dict.fromkeys(COMM_CATEGORIES, 0)
        self.steps = 0
        self.gossip_rounds = 0
        self.global_avgs = 0
        self.recoveries = 0

    def on_step(self, step: int) -> None:
        """Account one optimizer step (host integer math only)."""
        self.steps += 1
        if self.model.gossip_fires(step):
            self.gossip_rounds += 1
        if self.model.global_avg_fires(step):
            self.global_avgs += 1
        for k, v in self.model.step_bytes(step).items():
            self.totals[k] += v

    def on_recovery(self) -> None:
        """Account one reactive exact global average (recovery.py)."""
        self.recoveries += 1
        self.totals["recovery"] += self.model.recovery_bytes()

    def snapshot(self) -> dict:
        """JSON-safe state for a ``comm`` event / the final report."""
        return {"model": self.model.to_dict(), "steps": self.steps,
                "gossip_rounds": self.gossip_rounds,
                "global_avgs": self.global_avgs,
                "recoveries": self.recoveries,
                "bytes": dict(self.totals)}
