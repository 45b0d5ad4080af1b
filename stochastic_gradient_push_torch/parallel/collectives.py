"""Gossip collectives: the flat push-sum round (synchronous and split for
overlap), its gossip kernel lane, and AllReduce.

Port of ``stochastic_gradient_push_tpu/parallel/collectives.py`` for flat
schedules (``_round_fn:348``, ``gossip_round:618``, ``overlap_launch:670``,
``mix_push_sum:812``, ``mix_push_pull:845``, ``mix_bilat:863``,
``allreduce_mean:901``, the transport plan and the ``PendingShares`` FIFO
slot).  One round computes, per rank, ``lo * x +
Σ_i recv_i(w_i * x)`` with the schedule's phase tables: sender multiply
→ encode → transport → decode-add, edges folded in order ``i = 0, 1,
…``.  On the plain transport lane the elementwise ops follow the
reference's order and its compiled rounding (XLA fuses ``lo * x +
recv_0`` into one multiply-add, and an int8 decode-add likewise), so the
push-sum weight and the parameters come out bit-equal to the
reference's round on every wire (``tests/test_torch_collectives.py``).

**Kernel lane** (``kernel``, an :class:`~..ops.gossip_kernel.KernelLane`):
the payload leaves (per-rank size > 1) are packed into ``buckets``
contiguous byte-balanced transport buckets (:func:`_transport_plan`);
the (edge, leaf) loop only encodes and buffers, then each bucket is one
:func:`~..ops.gossip_kernel.gossip_edge_start` serving all edges and one
:func:`~..ops.gossip_kernel.gossip_edge_wait` into the packed
accumulator.  There the local share ``lo * x`` is rounded on its own and
the wait kernel adds the decoded edges to it, as the reference's kernel
lane does: params agree with the plain lane to ~1 ulp, not bit for bit.
The push-sum weight keeps the plain lane's code on both lanes, so it is
bit-identical across them.

**Overlap split** (:func:`overlap_launch`): the round separated into the
kept local share ``lo * x`` and the incoming share, whose sum is the
synchronous round.  On the kernel lane the incoming share is a
:class:`PendingShares` holding the live transport handles; it is
consumed once, by :func:`land_shares` or :func:`settle_share`.

Leaves are **rank-stacked**: dim 0 indexes the ranks this process holds.
The transport is a seam with two lanes:

* :class:`StackedTransport` — all ``W`` ranks in one process, the
  permutation an index gather along dim 0 (the counterpart of the
  reference's virtual-device mesh).  It serves the tests and runs on
  CUDA tensors as well;
* :class:`DistTransport` — one rank per process, each exchange one
  ``batch_isend_irecv`` pair (gloo on CPU, NCCL on GPU): what a
  multi-GPU run under ``torchrun`` uses.

The kernel lane runs on the stacked transport only; the cross-process
transport kernel is not ported and is refused by name.

Scalar leaves (per-rank size 1: the push-sum weight) never go through a
codec, so the weight lane stays exact f32.  At world 1 a round returns
its input, as the reference does at ``:764``.

Not ported yet: error feedback, fault masks, thinning's
``empty_incoming``, and the hierarchical and synthesized rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gossip_kernel as gk
from ..topology.schedule import GossipSchedule
from . import wire as wire_mod

__all__ = ["StackedTransport", "DistTransport", "PendingShares",
           "gossip_round", "overlap_launch", "land_shares", "settle_share",
           "mix_push_sum", "mix_push_pull", "mix_bilat", "allreduce_mean"]


class StackedTransport:
    """``world_size`` ranks as the leading dim of every leaf, in one
    process."""

    def __init__(self, world_size: int):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        self.world_size = int(world_size)
        self.ranks = np.arange(self.world_size)

    def permute(self, x: torch.Tensor, dests: np.ndarray) -> torch.Tensor:
        """Row ``src`` of ``x`` lands in row ``dests[src]``."""
        src = torch.as_tensor(np.argsort(dests), device=x.device)
        return x.index_select(0, src)

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0, keepdim=True).expand_as(x).clone()


class DistTransport:
    """One rank per process of the default ``torch.distributed`` group;
    leaves carry a leading dim of 1."""

    def __init__(self):
        import torch.distributed as dist

        self._dist = dist
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.ranks = np.array([self.rank])

    def permute(self, x: torch.Tensor, dests: np.ndarray) -> torch.Tensor:
        dist = self._dist
        dst = int(dests[self.rank])
        src = int(np.flatnonzero(np.asarray(dests) == self.rank)[0])
        send = x[0].contiguous()
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                       dist.P2POp(dist.irecv, recv, src)])
        for req in reqs:
            req.wait()
        return recv[None]

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        self._dist.all_reduce(out)
        return out


def _rank_weight(table: np.ndarray, transport, like: torch.Tensor):
    """The held ranks' weights from a per-rank table, shaped to broadcast
    over ``like``'s rank-stacked leaves: a scalar when all ranks share
    one value (as the reference constant-folds it), else ``[R, 1, …]``.
    float32, as the reference's weights are without x64."""
    if np.all(table == table[0]):
        return torch.tensor(np.float32(table[0]), device=like.device)
    w = torch.as_tensor(np.asarray(table, np.float32)[transport.ranks],
                        device=like.device)
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


def _is_payload(a: torch.Tensor) -> bool:
    """A real payload leaf: more than one element per rank."""
    return a[0].numel() > 1


def _resolve_codec(codec):
    """A lossless codec is the exact wire (None), as in the reference."""
    return codec if codec is not None and codec.lossy else None


def _kernel_spec(send_codec):
    """The decode the kernel lane runs for this resolved codec: the exact
    wire is the f32 passthrough; a lossy codec without a spec pins the
    plain lane."""
    if send_codec is None:
        return wire_mod.F32.kernel_spec()
    return send_codec.kernel_spec()


def _transport_plan(leaves, spec, num_buckets):
    """Static transport plan of the kernel lane: the payload leaf slots
    (per-rank size > 1) in ``num_buckets`` contiguous byte-balanced
    buckets.  Each bucket is a tuple of ``(slot, n, padded)``: the leaf's
    position, its per-rank element count, and its packed length (int8
    leaves pad to whole codec blocks, so scales stay block-local across
    the concatenation).  ``()`` when no leaf qualifies.  A dtype change
    between adjacent leaves forces a bucket boundary."""
    block = spec.block if spec.kind == "int8" else None
    items = []
    for j, a in enumerate(leaves):
        n = int(a[0].numel())
        if n <= 1:
            continue
        padded = n if block is None else -(-n // int(block)) * int(block)
        items.append((j, n, padded, a.dtype))
    if not items:
        return ()
    k = max(1, min(int(num_buckets), len(items)))
    total = float(sum(p for _, _, p, _ in items))
    buckets, cur, cum = [], [], 0.0
    for idx, (j, n, padded, dt) in enumerate(items):
        if cur and dt != cur[-1][3]:
            buckets.append(cur)
            cur = []
        cur.append((j, n, padded, dt))
        cum += padded
        left = len(items) - idx - 1
        need = k - len(buckets) - 1
        if left > 0 and need > 0 and (
                left == need
                or cum >= total * (len(buckets) + 1) / k):
            buckets.append(cur)
            cur = []
    if cur:
        buckets.append(cur)
    return tuple(tuple((j, n, p) for j, n, p, _ in b) for b in buckets)


def _bucket_len(bucket, spec, kernel) -> tuple[int, int]:
    """(packed payload length, its chunk-padded length) of one bucket."""
    total = sum(p for _, _, p in bucket)
    return total, gk.padded_len(spec, total, kernel.chunk_elems)


def _pack_bucket(bucket, sent, spec, ne, length):
    """One bucket's buffered encoded parts in the start kernel's
    rank-stacked ``[R, E, ...]`` layout, written straight into buffers
    of the chunk-padded ``length`` (the pad is zero): per edge, the
    bucket's leaves one after another (int8 along the block-row axis)."""
    first = sent[bucket[0][0]][0]
    ranks = first[0].shape[0]
    if spec.kind == "int8":
        rows = length // spec.block
        q = first[0].new_empty((ranks, ne, rows, spec.block))
        s = first[1].new_empty((ranks, ne, rows))
        off = 0
        for j, _, padded in bucket:
            nr = padded // spec.block
            for i in range(ne):
                qj, sj = sent[j][i]
                q[:, i, off:off + nr] = qj
                s[:, i, off:off + nr] = sj
            off += nr
        q[:, :, off:] = 0
        s[:, :, off:] = 0
        return (q, s)
    v = first[0].new_empty((ranks, ne, length))
    off = 0
    for j, n, _ in bucket:
        for i in range(ne):
            v[:, i, off:off + n] = sent[j][i][0].reshape(ranks, n)
        off += n
    v[:, :, off:] = 0
    return (v,)


def _pack_acc(bucket, acc, length, like=None):
    """One bucket's packed accumulator ``[R, length]``: each leaf raveled
    into its segment, zero in the pad lanes (they receive decode(0) == 0
    and are sliced away).  ``acc`` None packs zeros shaped by ``like``
    (a ``[R, ...]`` tensor giving ranks, dtype and device)."""
    if acc is None:
        return like.new_zeros((like.shape[0], length))
    first = acc[bucket[0][0]]
    ranks = first.shape[0]
    flat = first.new_empty((ranks, length))
    off = 0
    for j, n, padded in bucket:
        flat[:, off:off + n] = acc[j].reshape(ranks, n)
        flat[:, off + n:off + padded] = 0
        off += padded
    flat[:, off:] = 0
    return flat


def _unpack_acc(bucket, flat, acc, shapes):
    """Scatter a waited bucket back into the accumulator leaves (inverse
    of :func:`_pack_acc`), as views of ``flat``; mutates ``acc``."""
    off = 0
    for j, n, padded in bucket:
        acc[j] = flat[:, off:off + n].reshape(shapes[j])
        off += padded


class PendingShares:
    """One split round's deferred incoming share on the kernel lane.

    ``inc`` holds the leaves the plain lane carried (the exact ps-weight
    lane; ``None`` at bucketed slots), ``handles`` one live
    :class:`~..ops.gossip_kernel.TransportHandle` per transport bucket,
    ``plan`` the static bucket layout (:func:`_transport_plan`) and
    ``shapes`` every leaf's shape.  Consume it exactly once —
    :func:`land_shares` into the target leaves, or :func:`settle_share`
    to a plain share — to preserve push-sum mass."""

    def __init__(self, inc, handles, plan, shapes):
        self.inc = list(inc)
        self.handles = tuple(handles)
        self.plan = plan
        self.shapes = tuple(shapes)


def _land_buckets(incoming: PendingShares, out, zeros_like=None):
    """Wait each bucket of ``incoming`` into ``out`` (or into zeros)."""
    for handle, bucket in zip(incoming.handles, incoming.plan):
        _, n, _, c, nb, _, _ = handle.meta
        acc = _pack_acc(bucket, None if zeros_like is not None else out,
                        nb * c, like=zeros_like)
        _unpack_acc(bucket, gk.gossip_edge_wait(handle, acc), out,
                    incoming.shapes)
    return out


def land_shares(leaves, incoming):
    """Fold one incoming share into ``leaves`` — the one consume seam of
    the overlap FIFO.  A plain share (a list of leaves) is an elementwise
    add; a :class:`PendingShares` lands each bucket through the wait
    kernel (edges folded in order into the packed leaves), and its plain
    slots (the ps-weight) are adds."""
    if not isinstance(incoming, PendingShares):
        return [a + b.to(a.dtype) for a, b in zip(leaves, incoming)]
    if len(incoming.inc) != len(leaves):
        raise ValueError(
            "pending share does not mirror the target leaves "
            f"({len(incoming.inc)} vs {len(leaves)})")
    out = [a if b is None else a + b.to(a.dtype)
           for a, b in zip(leaves, incoming.inc)]
    return _land_buckets(incoming, out)


def settle_share(incoming):
    """A :class:`PendingShares` landed into zeros: the plain share the
    FIFO keeps between steps.  Plain shares pass through."""
    if not isinstance(incoming, PendingShares):
        return incoming
    out = [None if b is None else torch.zeros_like(b) + b
           for b in incoming.inc]
    like = incoming.handles[0].recv[0]
    zeros = torch.empty((like.shape[0], 0), dtype=torch.float32,
                        device=like.device)
    return _land_buckets(incoming, out, zeros_like=zeros)


def _round(leaves, p: int, schedule: GossipSchedule, transport, send_codec,
           split: bool, kernel, buckets: int):
    """One round at phase ``p``: the mixed leaves, or with ``split`` the
    pair ``(local, incoming)`` whose sum is the mixed leaves."""
    lo_table = schedule.self_weight[p]
    ne = schedule.peers_per_itr
    spec = _kernel_spec(send_codec) if kernel is not None else None
    plan = _transport_plan(leaves, spec, buckets) if spec is not None else ()
    bucketed = {j for bucket in plan for j, _, _ in bucket}
    sent = {j: [] for j in bucketed}
    out = list(leaves)
    inc = [None] * len(leaves)
    for j, a in enumerate(leaves):
        if split or j in bucketed:
            # the local share on its own rounding: the split's kept half,
            # and the kernel lane's accumulator
            lo = _rank_weight(lo_table, transport, a)
            out[j] = a * lo.to(a.dtype)
    for i in range(ne):
        dests = schedule.perms[p, i]
        for j, a in enumerate(leaves):
            w_i = _rank_weight(schedule.edge_weights[p, i], transport, a)
            msg = a * w_i.to(a.dtype)
            coded = send_codec is not None and _is_payload(msg)
            if j in bucketed:
                # kernel lane: encode and buffer; the bucket's start
                # kernel moves every edge at once after the loop
                sent[j].append(send_codec.encode(msg) if coded else (msg,))
                continue
            if coded:
                wire = tuple(transport.permute(x, dests)
                             for x in send_codec.encode(msg))
            else:
                # exact lane: payloads without a codec and every scalar
                # (ps-weight) leaf, codec or not
                wire = transport.permute(msg, dests)
            if split:
                # the incoming share alone: edge 0 is the received value
                # (the reference's 0 + recv folds to recv), later edges
                # add with the plain lane's rounding
                if i == 0:
                    inc[j] = send_codec.decode(wire, msg) if coded else wire
                elif coded:
                    inc[j] = send_codec.decode_add(wire, inc[j])
                else:
                    inc[j] = inc[j] + wire
            # the fold rounds as the reference's compiled round does:
            # edge 0 is one fused multiply-add lo * x + recv, later edges
            # add (an int8 decode-add is itself fused, see wire.py)
            elif i == 0:
                recv = send_codec.decode(wire, msg) if coded else wire
                lo = _rank_weight(schedule.self_weight[p], transport, a)
                out[j] = torch.addcmul(recv, a, lo.to(a.dtype))
            elif coded:
                out[j] = send_codec.decode_add(wire, out[j])
            else:
                out[j] = out[j] + wire
    handles = []
    if plan:
        dests = np.stack([schedule.perms[p, i] for i in range(ne)])
        shapes = [a.shape for a in leaves]
        for bucket in plan:
            total, length = _bucket_len(bucket, spec, kernel)
            parts = _pack_bucket(bucket, sent, spec, ne, length)
            for j, _, _ in bucket:
                del sent[j]
            handle = gk.gossip_edge_start(
                parts, dests, spec, n_decoded=total,
                interpret=kernel.interpret, chunk_elems=kernel.chunk_elems)
            del parts
            if split:
                # overlap launch: the handle rides the FIFO; the caller
                # waits it at the bottom of the step
                handles.append(handle)
            else:
                flat = gk.gossip_edge_wait(handle,
                                           _pack_acc(bucket, out, length))
                _unpack_acc(bucket, flat, out, shapes)
        if split:
            return out, PendingShares(inc, handles, plan, shapes)
    if split:
        return out, inc
    return out


def _apply_round(tree, phase: int, schedule: GossipSchedule, transport,
                 codec, split: bool, kernel, buckets: int):
    if buckets < 1:
        raise ValueError("buckets must be >= 1")
    if transport.world_size != schedule.world_size:
        raise ValueError(
            f"schedule was built for world_size={schedule.world_size} but "
            f"the transport holds world {transport.world_size}")
    if kernel is not None and not isinstance(transport, StackedTransport):
        raise NotImplementedError(
            "gossip_kernel='pallas' needs the stacked transport: the "
            "cross-process gossip_edge_start (one rank per GPU, peer-mapped "
            "buffers with a flag barrier, or NCCL across nodes) is not "
            "ported to stochastic_gradient_push_torch yet (ROADMAP.md "
            "Queue 2); use gossip_kernel='xla' under torch.distributed")
    leaves = list(tree)
    if schedule.world_size == 1:
        if split:
            return leaves, [torch.zeros_like(a) for a in leaves]
        return leaves
    return _round(leaves, phase % schedule.num_phases, schedule, transport,
                  _resolve_codec(codec), split, kernel, buckets)


def gossip_round(tree, phase: int, schedule: GossipSchedule, transport,
                 codec=None, kernel=None, buckets: int = 1):
    """One synchronous gossip round over a list of rank-stacked leaves:
    ``lo * x + Σ_i permute_i(w_i * x)`` at ``phase % num_phases``.
    ``kernel`` (a :class:`~..ops.gossip_kernel.KernelLane`) moves the
    payload leaves through the start/wait kernels in ``buckets``
    transport buckets; None is the plain transport lane."""
    return _apply_round(tree, phase, schedule, transport, codec, False,
                        kernel, buckets)


def overlap_launch(tree, phase: int, schedule: GossipSchedule, transport,
                   codec=None, kernel=None, buckets: int = 1):
    """Launch half of the overlap round: ``(local, incoming)``, the kept
    share ``lo * x`` and the received share, whose sum is
    :func:`gossip_round`.  ``incoming`` is a list of leaves on the plain
    lane and a :class:`PendingShares` on the kernel lane (the start
    kernels have run; the waits happen where it is consumed)."""
    return _apply_round(tree, phase, schedule, transport, codec, True,
                        kernel, buckets)


def mix_push_sum(params: dict, ps_weight: torch.Tensor, phase: int,
                 schedule: GossipSchedule, transport, codec=None,
                 kernel=None, buckets: int = 1):
    """Push-sum round: parameters and the push-sum weight ``[R]`` mixed
    jointly, the weight always on the exact lane.  Returns
    ``(params, ps_weight)``."""
    names = list(params)
    mixed = gossip_round([params[n] for n in names] + [ps_weight], phase,
                         schedule, transport, codec=codec, kernel=kernel,
                         buckets=buckets)
    return dict(zip(names, mixed[:-1])), mixed[-1]


def mix_push_pull(params: dict, phase: int, schedule: GossipSchedule,
                  transport, codec=None, kernel=None,
                  buckets: int = 1) -> dict:
    """Doubly-stochastic (D-PSGD) round: :func:`gossip_round` over the
    parameters alone, with no push-sum weight leaf.  Uniform mixing on a
    regular graph is doubly stochastic, so the mean is kept without a
    weight; an irregular schedule is refused.  On the kernel lane the
    payload goes through the start and wait kernels as in
    :func:`mix_push_sum`."""
    if not schedule.regular:
        raise ValueError("push-pull requires a regular schedule "
                         "(doubly-stochastic mixing)")
    names = list(params)
    mixed = gossip_round([params[n] for n in names], phase, schedule,
                         transport, codec=codec, kernel=kernel,
                         buckets=buckets)
    return dict(zip(names, mixed))


def mix_bilat(params: dict, phase: int, pairing: np.ndarray,
              transport) -> dict:
    """Bilateral pairwise averaging (AD-PSGD's exchange, synchronous):
    ``x <- (x + x_partner) * 0.5`` in each leaf's dtype, with the partner
    ``pairing[phase % num_phases]``.  Each row of ``pairing`` is an
    involution, so one :meth:`permute` moves both directions of every
    pair: on the stacked transport a gather along the rank dim, under
    ``torch.distributed`` one send to and one receive from the partner.
    No gossip kernel runs here (the reference's is a ``ppermute``)."""
    num_phases, world = pairing.shape
    if transport.world_size != world:
        raise ValueError(
            f"pairing was built for world_size={world} but the transport "
            f"holds world {transport.world_size}")
    if world == 1:
        return params
    row = np.asarray(pairing[phase % num_phases])
    return {n: (a + transport.permute(a, row)) * 0.5
            for n, a in params.items()}


def allreduce_mean(tree: dict, transport) -> dict:
    """Exact all-reduce mean (the AllReduce baseline's gradient average)."""
    return {n: transport.allreduce_sum(a) / transport.world_size
            for n, a in tree.items()}
