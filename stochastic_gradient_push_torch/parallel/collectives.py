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
lane does: params agree with the plain lane to ~1 ulp, not bit for bit
(exactly where ``lo * x`` is exact, as at one peer under uniform
mixing).  A fault's reabsorbed weight is added after the wait, where
the plain lane adds it after the received edge (the reference's kernel
lane adds it before the wait, a rounding apart).
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
  ``batch_isend_irecv`` pair (gloo on CPU, NCCL on GPU; CUDA tensors
  cross a gloo group through host copies): what a run under ``torchrun``
  uses.

Both carry the kernel lane: a transport's :meth:`edge_start` is the
stacked :func:`~..ops.gossip_kernel.gossip_edge_start` or the
cross-process :func:`~..ops.gossip_kernel.gossip_edge_start_dist` (peer
landing blocks mapped by CUDA IPC on the card, its twin over
``torch.distributed`` on the CPU), and the same wait lands either.

Scalar leaves (per-rank size 1: the push-sum weight) never go through a
codec, so the weight lane stays exact f32.  At world 1 a round returns
its input, as the reference does at ``:764``.

**Error feedback** (``ef_residual``): round ``t`` sends ``Q(w_0·x + r)``
on edge 0 of ranks that send (``w_0 > 0``) and returns the round's total
quantization error as the new residual, computed from the same encoded
parts both lanes ship; a residual whose edge was dropped stays pending.
**Faults** (``faults``, ``resilience/faults.py``): a corrupted rank's
payloads become NaN, a dropped edge ships zero (``where``, never
``0·NaN``) and its weight is reabsorbed into the sender's local share,
so the mean is kept.  Both run on both lanes and in the overlap split,
the fault rows read at the launch tick.  A round's weights and fault
rows are device tables made once (per schedule phase, per fault table),
so a round copies nothing from the host.

**Layout**: a blocked codec (int8) encodes each leaf in the reference's
layout (``perms``, from ``models/convert.py::reference_layout``), so
its blocks and scales are the reference's; the decode, the kernel
lane's packed accumulator and the residual come back through the
inverse permutation.

**Hierarchical and synthesized schedules** (``topology/hierarchical.py``,
``topology/synthesized.py``): a hierarchical round is the flat round over
the delegate tables (:attr:`HierarchicalSchedule.inter_schedule` at round
``phase % rounds_per_cycle``), then :func:`intra_average`, the exact mean
inside each slice; the codec, the error-feedback residual and the kernel
lane ride the delegate round only.  A synthesized round is, per table
phase, a flat round over the edge phase's one-edge tables, or one
grouped mean (psum phase) that leaves the residual as it is.  The grouped
mean is the reference's ``lax.psum(a * float32(1/s),
axis_index_groups=...)``: on :class:`StackedTransport` the rows of each
group are summed in rank order, under ``torch.distributed`` it is one
``all_reduce`` on a process subgroup made once per group.  Fault
injection is refused on both kinds and overlap on synthesized ones, as
the reference refuses them; an overlap launch on a hierarchical schedule
defers the delegate share, and the caller runs :func:`intra_average`
where it consumes it.

Not ported: thinning's ``empty_incoming`` (a skipped overlap step puts a
plain zero share in the FIFO instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gossip_kernel as gk
from ..topology.hierarchical import HierarchicalSchedule
from ..topology.schedule import GossipSchedule
from ..topology.synthesized import SynthesizedSchedule
from . import wire as wire_mod

__all__ = ["StackedTransport", "DistTransport", "PendingShares",
           "gossip_round", "overlap_launch", "land_shares", "settle_share",
           "intra_average", "mix_push_sum", "mix_push_pull", "mix_bilat",
           "allreduce_mean"]


def _scaled(x: torch.Tensor, inv: float) -> torch.Tensor:
    """``x * inv`` with ``inv`` rounded to ``x``'s dtype first, as the
    reference's ``a * jnp.asarray(1/s, a.dtype)``.  The rounded value is
    a host scalar (exact in the dtype), so no copy to the device."""
    return x * float(torch.tensor(inv, dtype=x.dtype))


def _flat_by_dtype(leaves):
    """The rank-stacked leaves raveled and concatenated per dtype: a list
    of ``(flat [R, N], [(leaf index, n), ...])``, so a grouped mean is a
    few launches (and one collective) over all leaves."""
    order: dict = {}
    for j, a in enumerate(leaves):
        order.setdefault(a.dtype, []).append(j)
    return [(torch.cat([leaves[j].reshape(leaves[j].shape[0], -1)
                        for j in js], 1),
             [(j, leaves[j][0].numel()) for j in js])
            for js in order.values()]


def _unflatten(out: list, leaves, flat, index) -> None:
    """Views of ``flat`` back into ``out``, shaped like ``leaves``."""
    off = 0
    for j, n in index:
        out[j] = flat[:, off:off + n].reshape(leaves[j].shape)
        off += n


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

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's row on the host: ``x`` itself."""
        return x.detach().cpu()

    def edge_start(self, parts, dests, spec, n_decoded: int, kernel,
                   slot=0):
        """The kernel lane's start of one transport bucket."""
        return gk.gossip_edge_start(parts, dests, spec, n_decoded=n_decoded,
                                    interpret=kernel.interpret,
                                    chunk_elems=kernel.chunk_elems)

    def check(self) -> None:
        """Nothing crosses a process here: nothing to have lost."""

    def close(self) -> None:
        """Nothing to free."""

    def allreduce_min(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(0, keepdim=True).expand_as(x).clone()

    def allreduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0, keepdim=True).expand_as(x).clone()

    def group_mean(self, leaves, groups) -> list:
        """The exact mean inside each of ``groups`` (equal contiguous rank
        blocks covering the world, as both schedule kinds make them) of
        every leaf, written back to every row of the block: the rows of
        ``x * float32(1/s)`` summed in rank order.  The leaves go through
        as one raveled tensor per dtype (the outputs are views of it)."""
        s, m = len(groups[0]), len(groups)
        if m * s != self.world_size or [tuple(g) for g in groups] != [
                tuple(range(j * s, (j + 1) * s)) for j in range(m)]:
            raise ValueError("group_mean takes equal contiguous rank "
                             f"blocks covering the world, got {groups}")
        out = list(leaves)
        for flat, index in _flat_by_dtype(leaves):
            blocks = _scaled(flat, 1.0 / s).view(m, s, -1)
            acc = blocks[:, 0]
            for k in range(1, s):
                acc = acc + blocks[:, k]
            _unflatten(out, leaves, acc.unsqueeze(1).expand_as(blocks)
                       .reshape(flat.shape), index)
        return out


class DistTransport:
    """One rank per process of the default ``torch.distributed`` group;
    leaves carry a leading dim of 1.  On a gloo group CUDA tensors go
    through host copies (gloo moves host memory); the kernel lane's
    payload never does: its start maps the peers' landing blocks
    (``links``, a :class:`~..ops.gossip_kernel.PeerLinks` made at the
    kernel lane's first start, whose waits give up after ``timeout_s``;
    the plain lane never makes one)."""

    def __init__(self, timeout_s: float = gk.PEER_TIMEOUT_S):
        import torch.distributed as dist

        self._dist = dist
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.ranks = np.array([self.rank])
        self._groups: dict = {}
        self._staged = dist.get_backend() == dist.Backend.GLOO
        self._nccl = dist.get_backend() == dist.Backend.NCCL
        self.timeout_s = timeout_s
        self.links = None

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the group's backend takes it: on the host for
        gloo, on this process's card for NCCL."""
        if self._staged and x.is_cuda:
            return x.cpu()
        if self._nccl and not x.is_cuda:
            return x.cuda()
        return x

    def permute(self, x: torch.Tensor, dests: np.ndarray) -> torch.Tensor:
        dist = self._dist
        dst = int(dests[self.rank])
        if dst == self.rank:
            # a rank the permutation fixes (a hierarchical non-delegate,
            # a synthesized edge phase's idle rank) keeps its value: no
            # message, as gloo refuses a send to itself
            return x.clone()
        src = int(np.flatnonzero(np.asarray(dests) == self.rank)[0])
        send = self._host(x[0].contiguous())
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                       dist.P2POp(dist.irecv, recv, src)])
        for req in reqs:
            req.wait()
        return recv.to(x.device)[None]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's row of ``x`` (``[1, ...]``) on the host, in rank
        order: ``[world, ...]``."""
        send = self._host(x.detach().contiguous())
        rows = [torch.empty_like(send) for _ in range(self.world_size)]
        self._dist.all_gather(rows, send)
        return torch.cat(rows).cpu()

    def edge_start(self, parts, dests, spec, n_decoded: int, kernel,
                   slot=0):
        """The kernel lane's start of transport bucket ``slot``, across
        processes."""
        if self.links is None:
            self.links = gk.PeerLinks(self.rank, self.world_size,
                                      self.timeout_s)
        return gk.gossip_edge_start_dist(
            parts, dests, spec, self.links, slot=slot, n_decoded=n_decoded,
            interpret=kernel.interpret, chunk_elems=kernel.chunk_elems)

    def check(self) -> None:
        """Raise ``PeerLostError`` for a kernel-lane wait that gave up."""
        if self.links is not None:
            self.links.check()

    def close(self) -> None:
        """Free the kernel lane's landing blocks (collective)."""
        if self.links is not None:
            self.links.close()

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def allreduce_min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MIN)

    def allreduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def _reduce(self, x: torch.Tensor, op, group=None) -> torch.Tensor:
        out = self._host(x).clone()
        self._dist.all_reduce(out, op=op, group=group)
        return out.to(x.device)

    def group_mean(self, leaves, groups) -> list:
        """The exact mean inside this rank's group of ``groups``, of every
        leaf: one ``all_reduce`` of the raveled ``x * float32(1/s)`` per
        dtype on the group's process subgroup.  ``new_group`` is
        collective over the default group, so every process makes every
        group of a grouping, in one order, the first time the grouping
        is seen, and never again."""
        key = tuple(tuple(int(r) for r in g) for g in groups)
        if key not in self._groups:
            made = [self._dist.new_group(list(g)) for g in key]
            self._groups[key] = next(pg for g, pg in zip(key, made)
                                     if self.rank in g)
        out = list(leaves)
        for flat, index in _flat_by_dtype(leaves):
            _unflatten(out, leaves, self._reduce(
                _scaled(flat, 1.0 / len(key[0])), self._dist.ReduceOp.SUM,
                self._groups[key]), index)
        return out


def check_kernel_transport(transport) -> None:
    """The kernel lane moves payloads through a transport's
    ``edge_start``: the stacked one or the cross-process one."""
    if not isinstance(transport, (StackedTransport, DistTransport)):
        raise TypeError(
            "gossip_kernel='pallas' runs on the stacked transport or the "
            "cross-process one (DistTransport: peer-mapped landing blocks "
            f"with a flag barrier), not on a {type(transport).__name__}")


_PHASE_TABLES: dict = {}


def _phase_tables(schedule: GossipSchedule, p: int, transport, device):
    """The held ranks' weights of phase ``p`` on ``device``: ``lo``
    float32 ``[R]`` and ``w`` float32 ``[E, R]`` (float32, as the
    reference's weights are without x64).  Built once per (schedule,
    phase, ranks, device) and reused, so a round copies nothing from the
    host."""
    key = (id(schedule), p, tuple(transport.ranks), str(device))
    hit = _PHASE_TABLES.get(key)
    if hit is None or hit[0] is not schedule:
        ranks = np.asarray(transport.ranks)
        lo = np.asarray(schedule.self_weight[p], np.float32)[ranks]
        w = np.asarray(schedule.edge_weights[p], np.float32)[:, ranks]
        hit = (schedule, torch.from_numpy(lo).to(device),
               torch.from_numpy(np.ascontiguousarray(w)).to(device))
        _PHASE_TABLES[key] = hit
    return hit[1], hit[2]


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank ``[R]`` table as a view broadcasting over ``like``'s
    rank-stacked leaves, in ``like``'s dtype."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1)).to(like.dtype)


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


def _to_ref(x: torch.Tensor, perm) -> torch.Tensor:
    """A rank-stacked leaf viewed in the reference's layout (``perm``
    permutes the per-rank dims; None is the identity)."""
    if perm is None:
        return x
    return x.permute(0, *(d + 1 for d in perm))


def _from_ref(x: torch.Tensor, perm) -> torch.Tensor:
    """Inverse of :func:`_to_ref`, made contiguous in the port's
    layout."""
    if perm is None:
        return x
    inv = np.argsort(perm)
    return x.permute(0, *(int(d) + 1 for d in inv)).contiguous()


def _pack_acc(bucket, acc, length, like=None, perms=None):
    """One bucket's packed accumulator ``[R, length]``: each leaf raveled
    into its segment, in the reference's layout where ``perms[j]`` says
    (the int8 blocks of the encoded parts were cut there), zero in the
    pad lanes (they receive decode(0) == 0 and are sliced away).
    ``acc`` None packs zeros shaped by ``like`` (a ``[R, ...]`` tensor
    giving ranks, dtype and device)."""
    if acc is None:
        return like.new_zeros((like.shape[0], length))
    first = acc[bucket[0][0]]
    ranks = first.shape[0]
    flat = first.new_empty((ranks, length))
    off = 0
    for j, n, padded in bucket:
        perm = perms[j] if perms is not None else None
        src = _to_ref(acc[j], perm)
        flat[:, off:off + n].view(src.shape).copy_(src)
        flat[:, off + n:off + padded] = 0
        off += padded
    flat[:, off:] = 0
    return flat


def _unpack_acc(bucket, flat, acc, shapes, perms=None):
    """Scatter a waited bucket back into the accumulator leaves (inverse
    of :func:`_pack_acc`): views of ``flat``, or, for a leaf packed in
    the reference's layout, one copy back into the port's; mutates
    ``acc``."""
    off = 0
    for j, n, padded in bucket:
        perm = perms[j] if perms is not None else None
        if perm is None:
            acc[j] = flat[:, off:off + n].reshape(shapes[j])
        else:
            ref = (shapes[j][0],) + tuple(shapes[j][1 + d] for d in perm)
            acc[j] = _from_ref(flat[:, off:off + n].reshape(ref), perm)
        off += padded


class PendingShares:
    """One split round's deferred incoming share on the kernel lane.

    ``inc`` holds the leaves the plain lane carried (the exact ps-weight
    lane; ``None`` at bucketed slots), ``handles`` one live
    :class:`~..ops.gossip_kernel.TransportHandle` per transport bucket,
    ``plan`` the static bucket layout (:func:`_transport_plan`),
    ``shapes`` every leaf's shape and ``perms`` each leaf's reference
    layout (None: the port's).  Consume it exactly once —
    :func:`land_shares` into the target leaves, or :func:`settle_share`
    to a plain share — to preserve push-sum mass."""

    def __init__(self, inc, handles, plan, shapes, perms=None):
        self.inc = list(inc)
        self.handles = tuple(handles)
        self.plan = plan
        self.shapes = tuple(shapes)
        self.perms = perms


def _land_buckets(incoming: PendingShares, out, zeros_like=None):
    """Wait each bucket of ``incoming`` into ``out`` (or into zeros)."""
    for handle, bucket in zip(incoming.handles, incoming.plan):
        _, n, _, c, nb, _, _ = handle.meta
        acc = _pack_acc(bucket, None if zeros_like is not None else out,
                        nb * c, like=zeros_like, perms=incoming.perms)
        _unpack_acc(bucket, gk.gossip_edge_wait(handle, acc), out,
                    incoming.shapes, incoming.perms)
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


def _decode(codec, wire, msg_ref, perm):
    """The received payload in the port's layout (decoded where the
    codec's blocks were cut)."""
    return _from_ref(codec.decode(wire, msg_ref), perm)


def _decode_add(codec, wire, acc, perm):
    """``acc + decode(wire)`` with the codec's rounding, in the port's
    layout."""
    return _from_ref(codec.decode_add(wire, _to_ref(acc, perm)), perm)


def _shared_product(schedule, p: int, send_codec, keep_t, corrupt_t,
                    ef: bool):
    """Where the reference's compiled round rounds edge 0's error-feedback
    message ``w_0·x + r`` in two steps for its quantization error: when
    a later edge has edge 0's weight table, XLA computes ``w_0·x`` once
    for both, and a product with two uses is not fused into the add.
    For an elementwise codec without corruption the fusion is
    specialised per rank on the later edge's keep row, so the two-step
    rounding holds only where that edge sends.  None: nowhere; True: on
    every rank; else a float ``[R]`` mask."""
    if not ef:
        return None
    w = np.asarray(schedule.edge_weights[p], np.float32)
    later = [i for i in range(1, schedule.peers_per_itr)
             if np.array_equal(w[0], w[i])]
    if not later:
        return None
    if keep_t is None or corrupt_t is not None or send_codec.blocked:
        return True
    return (keep_t[later] > 0).any(0).float()


def _round(leaves, p: int, schedule: GossipSchedule, transport, send_codec,
           split: bool, kernel, buckets: int, faults=None, tick: int = 0,
           residual=None, perms=None):
    """One round at phase ``p``: ``(mixed, new_residual)``, or with
    ``split`` ``((local, incoming), new_residual)`` whose sum is the
    mixed leaves; ``new_residual`` is None without error feedback.

    The reference's ``_round_fn`` (``parallel/collectives.py:348``):
    per edge, the sender multiply ``w_i * x`` (plus the pending residual
    on edge 0, gated by ``w_0 > 0``), NaN corruption of real payloads,
    the keep mask (``where``, so a dropped corrupted message is 0), the
    encode, and the quantization error of the parts the transport ships;
    after each edge the sender reabsorbs a dropped edge's weight into
    its local share.  The rounding follows the reference's compiled
    round (``torch.addcmul`` where XLA fuses a multiply-add; see
    ``tests/test_torch_faults.py``)."""
    lo_t, w_t = _phase_tables(schedule, p, transport, leaves[0].device)
    keep_t = corrupt_t = None
    if faults is not None:
        keep_t, corrupt_t = faults.rows_on(tick, leaves[0].device)
        if len(transport.ranks) != schedule.world_size:
            keep_t = keep_t[:, transport.ranks]
            corrupt_t = (None if corrupt_t is None
                         else corrupt_t[transport.ranks])
    reabsorb = keep_t is not None and faults.reabsorb
    ne = schedule.peers_per_itr
    spec = _kernel_spec(send_codec) if kernel is not None else None
    plan = _transport_plan(leaves, spec, buckets) if spec is not None else ()
    bucketed = {j for bucket in plan for j, _, _ in bucket}
    sent = {j: [] for j in bucketed}
    if perms is None or send_codec is None or not send_codec.blocked:
        perms = [None] * len(leaves)
    err = list(residual) if residual is not None else None
    shared = _shared_product(schedule, p, send_codec, keep_t, corrupt_t,
                             residual is not None)
    out = list(leaves)
    inc = [None] * len(leaves)
    first = {}
    # the local share of the split's kept half and of the kernel lane's
    # accumulator: rounded on its own, or in the split fused with the
    # first reabsorption (the reference's compiled rounding).  A
    # synchronous kernel-lane leaf takes its reabsorbed weight after the
    # wait, as the plain lane folds it after the received edge
    local = [j for j in range(len(leaves)) if split or j in bucketed]
    defer = set() if split else bucketed
    drop_ws = []
    for j in local:
        if not reabsorb or j in defer:
            out[j] = leaves[j] * _col(lo_t, leaves[j])
    for i in range(ne):
        dests = schedule.perms[p, i]
        w_i, keep_i = w_t[i], (keep_t[i] if keep_t is not None else None)
        gate = (w_i > 0).float() if residual is not None and i == 0 \
            else None
        for j, a in enumerate(leaves):
            payload = _is_payload(a)
            inject = gate is not None and payload
            msg_err = None
            if inject:
                # error feedback: the pending residual rides the first
                # outgoing message of ranks that send
                r = residual[j].to(a.dtype)
                msg = torch.addcmul(r * _col(gate, a), a, _col(w_i, a))
                if shared is not None:
                    # the reference's error fusion shares w_0 * x with a
                    # later edge's message and rounds it there alone
                    msg_err = a * _col(w_i, a) + r * _col(gate, a)
                    if shared is not True:
                        msg_err = torch.where(_col(shared, a) > 0, msg_err,
                                              msg)
            else:
                msg = a * _col(w_i, a)
            msgs = [msg] if msg_err is None else [msg, msg_err]
            if corrupt_t is not None and payload:
                msgs = [m.masked_fill(_col(corrupt_t, a) > 0, float("nan"))
                        for m in msgs]
            if keep_i is not None:
                msgs = [m.masked_fill(_col(keep_i, a) <= 0, 0.0)
                        for m in msgs]
            msg = msgs[0]
            coded = send_codec is not None and payload
            if coded:
                ref = _to_ref(msg, perms[j])
                parts = send_codec.encode(ref)
                if err is not None:
                    # the quantization error of the parts both lanes ship
                    q_err = _from_ref(send_codec.error(
                        parts, _to_ref(msgs[-1], perms[j])), perms[j])
                    if inject:
                        # carry rule: a residual that did not go out (w_0
                        # == 0, or the edge dropped) stays pending
                        attempt = (gate if keep_i is None
                                   else gate * keep_i)
                        err[j] = q_err + r * _col(1.0 - attempt, a)
                    else:
                        err[j] = err[j] + q_err
            if j in bucketed:
                # kernel lane: encode and buffer; the bucket's start
                # kernel moves every edge at once after the loop
                sent[j].append(parts if coded else (msg,))
                continue
            if coded:
                wire = tuple(transport.permute(x, dests) for x in parts)
            else:
                # exact lane: payloads without a codec and every scalar
                # (ps-weight) leaf, codec or not
                wire = transport.permute(msg, dests)
            if split:
                # the incoming share alone: edge 0 is the received value
                # (the reference's 0 + recv folds to recv), later edges
                # add with the plain lane's rounding
                if i == 0:
                    inc[j] = (_decode(send_codec, wire, ref, perms[j])
                              if coded else wire)
                    first[j] = wire
                elif coded and i == 1:
                    # XLA fuses edge 0's decode into the add: edge 1
                    # rounds on its own
                    inc[j] = _decode_add(send_codec, first.pop(j),
                                         _decode(send_codec, wire, ref,
                                                 perms[j]), perms[j])
                elif coded:
                    inc[j] = _decode_add(send_codec, wire, inc[j], perms[j])
                else:
                    inc[j] = inc[j] + wire
            # the fold rounds as the reference's compiled round does:
            # edge 0 is one fused multiply-add lo * x + recv, later edges
            # add (an int8 decode-add is itself fused, see wire.py)
            elif i == 0:
                recv = (_decode(send_codec, wire, ref, perms[j])
                        if coded else wire)
                out[j] = torch.addcmul(recv, a, _col(lo_t, a))
            elif coded:
                out[j] = _decode_add(send_codec, wire, out[j], perms[j])
            else:
                out[j] = out[j] + wire
        if reabsorb:
            # the sender keeps a dropped edge's weight: every column of
            # the effective matrix still sums to 1
            drop_w = w_i * (1.0 - keep_i)
            drop_ws.append(drop_w)
            for j, a in enumerate(leaves):
                if j in defer:
                    continue
                if i == 0 and j in local:
                    out[j] = torch.addcmul(a * _col(drop_w, a), a,
                                           _col(lo_t, a))
                else:
                    out[j] = torch.addcmul(out[j], a, _col(drop_w, a))
    handles = []
    if plan:
        dests = np.stack([schedule.perms[p, i] for i in range(ne)])
        shapes = [a.shape for a in leaves]
        for slot, bucket in enumerate(plan):
            total, length = _bucket_len(bucket, spec, kernel)
            parts = _pack_bucket(bucket, sent, spec, ne, length)
            for j, _, _ in bucket:
                del sent[j]
            handle = transport.edge_start(parts, dests, spec, total, kernel,
                                          slot=slot)
            del parts
            if split:
                # overlap launch: the handle rides the FIFO; the caller
                # waits it at the bottom of the step
                handles.append(handle)
            else:
                flat = gk.gossip_edge_wait(
                    handle, _pack_acc(bucket, out, length, perms=perms))
                _unpack_acc(bucket, flat, out, shapes, perms)
                for j, _, _ in bucket:
                    for drop_w in drop_ws:
                        out[j] = torch.addcmul(out[j], leaves[j],
                                               _col(drop_w, leaves[j]))
        if split:
            return (out, PendingShares(inc, handles, plan, shapes,
                                       perms)), err
    if split:
        return (out, inc), err
    return out, err


def intra_average(leaves, hsched: HierarchicalSchedule, transport):
    """The exact intra-slice mean of a hierarchical round over every leaf
    (the ps-weight included): the transport's grouped mean, numerically
    ``W_intra @ x``.  Public because the overlap consume path runs it on
    its own, after the deferred delegate share lands."""
    return transport.group_mean(leaves, hsched.slice_groups)


_EDGE_SCHEDULES: dict = {}


def _edge_schedule(ssched: SynthesizedSchedule, p: int) -> GossipSchedule:
    """``ssched.edge_phase_schedule(p)``, made once per (schedule,
    phase), so its device weight tables are made once too."""
    key = (id(ssched), p)
    hit = _EDGE_SCHEDULES.get(key)
    if hit is None or hit[0] is not ssched:
        hit = (ssched, ssched.edge_phase_schedule(p))
        _EDGE_SCHEDULES[key] = hit
    return hit[1]


def _apply_round(tree, phase: int, schedule: GossipSchedule, transport,
                 codec, split: bool, kernel, buckets: int, faults=None,
                 tick=None, residual=None, perms=None):
    if buckets < 1:
        raise ValueError("buckets must be >= 1")
    if isinstance(schedule, HierarchicalSchedule) and faults is not None:
        raise ValueError(
            "fault injection is not supported on hierarchical "
            "schedules: the intra-slice psum has no per-edge mask "
            "(use a flat topology for fault drills)")
    if isinstance(schedule, SynthesizedSchedule):
        if faults is not None:
            raise ValueError(
                "fault injection is not supported on synthesized "
                "schedules: grouped psum phases have no per-edge mask "
                "(use a flat registry topology for fault drills)")
        if split:
            raise ValueError(
                "overlap is not supported on synthesized schedules: a "
                "psum/ppermute phase composition has no single "
                "augmented in-flight form (use a registry topology for "
                "overlap runs)")
    send_codec = _resolve_codec(codec)
    if residual is not None and send_codec is None:
        raise ValueError(
            "error feedback needs a lossy wire codec (bf16/int8); exact "
            "wires have no quantization error to feed back")
    if transport.world_size != schedule.world_size:
        raise ValueError(
            f"schedule was built for world_size={schedule.world_size} but "
            f"the transport holds world {transport.world_size}")
    if kernel is not None:
        check_kernel_transport(transport)
    leaves = list(tree)
    if residual is not None:
        residual = list(residual)
        if len(residual) != len(leaves):
            raise ValueError(
                "ef residual tree does not mirror the mixed tree "
                f"({len(residual)} vs {len(leaves)} leaves)")
    if schedule.world_size == 1:
        if split:
            return (leaves, [torch.zeros_like(a) for a in leaves]), residual
        return leaves, residual
    args = (transport, send_codec, split, kernel, buckets)
    if isinstance(schedule, SynthesizedSchedule):
        p = phase % schedule.num_phases
        if schedule.phase_kinds[p] == "psum":
            # an exact grouped mean: no wire, so no quantization error
            # and the residual passes through
            return transport.group_mean(leaves,
                                        schedule.phase_groups[p]), residual
        return _round(leaves, 0, _edge_schedule(schedule, p), *args,
                      residual=residual, perms=perms)
    if isinstance(schedule, HierarchicalSchedule):
        # a round spans two table phases: the delegate round q of the
        # inter tables, then the intra-slice mean (at consume, under
        # overlap)
        out, err = _round(leaves, phase % schedule.rounds_per_cycle,
                          schedule.inter_schedule, *args,
                          residual=residual, perms=perms)
        if split:
            return out, err
        return intra_average(out, schedule, transport), err
    return _round(leaves, phase % schedule.num_phases, schedule, *args,
                  faults=faults, tick=phase if tick is None else int(tick),
                  residual=residual, perms=perms)


def gossip_round(tree, phase: int, schedule: GossipSchedule, transport,
                 codec=None, kernel=None, buckets: int = 1, faults=None,
                 tick=None, ef_residual=None, perms=None):
    """One synchronous gossip round over a list of rank-stacked leaves:
    ``lo * x + Σ_i permute_i(w_i * x)`` at ``phase % num_phases``.
    ``kernel`` (a :class:`~..ops.gossip_kernel.KernelLane`) moves the
    payload leaves through the start/wait kernels in ``buckets``
    transport buckets; None is the plain transport lane.

    ``faults`` (a :class:`~..resilience.faults.FaultMasks`) masks the
    round with its rows at ``tick`` (default ``phase``; the step clock
    under thinning), the dropped weight reabsorbed by the sender.
    ``ef_residual`` (leaves mirroring ``tree``) turns on error feedback
    with a lossy codec; the call then returns ``(mixed, new_residual)``.
    ``perms`` (one per leaf, None for the identity) is the reference's
    layout of each leaf, where a blocked codec (int8) cuts its blocks."""
    mixed, new_res = _apply_round(tree, phase, schedule, transport, codec,
                                  False, kernel, buckets, faults, tick,
                                  ef_residual, perms)
    return mixed if ef_residual is None else (mixed, new_res)


def overlap_launch(tree, phase: int, schedule: GossipSchedule, transport,
                   codec=None, kernel=None, buckets: int = 1, faults=None,
                   tick=None, ef_residual=None, perms=None):
    """Launch half of the overlap round: ``(local, incoming)``, the kept
    share ``lo * x`` (reabsorbed fault weight included) and the received
    share, whose sum is :func:`gossip_round`; ``(local, incoming,
    new_residual)`` with ``ef_residual``.  ``incoming`` is a list of
    leaves on the plain lane and a :class:`PendingShares` on the kernel
    lane (the start kernels have run; the waits happen where it is
    consumed).  Fault rows are read at the launch ``tick``."""
    (local, incoming), new_res = _apply_round(
        tree, phase, schedule, transport, codec, True, kernel, buckets,
        faults, tick, ef_residual, perms)
    if ef_residual is None:
        return local, incoming
    return local, incoming, new_res


def _leaf_perms(names, layout, extra: int):
    """Each named leaf's reference layout from ``layout`` (a
    :class:`~.wire.ReferenceLayout`), None for ``extra`` trailing
    leaves."""
    if layout is None:
        return None
    return [layout.perm(n) for n in names] + [None] * extra


def mix_push_sum(params: dict, ps_weight: torch.Tensor, phase: int,
                 schedule: GossipSchedule, transport, codec=None,
                 kernel=None, buckets: int = 1, faults=None, tick=None,
                 ef_residual: dict | None = None, layout=None):
    """Push-sum round: parameters and the push-sum weight ``[R]`` mixed
    jointly, the weight always on the exact lane.  Returns ``(params,
    ps_weight)``, or ``(params, ps_weight, new_residual)`` with
    ``ef_residual`` (a dict mirroring ``params``).  ``layout`` (a
    :class:`~.wire.ReferenceLayout`) places the int8 blocks as the
    reference cuts them."""
    names = list(params)
    leaves = [params[n] for n in names] + [ps_weight]
    res = None
    if ef_residual is not None:
        res = [ef_residual[n] for n in names] + [torch.zeros_like(ps_weight)]
    mixed, new_res = _apply_round(
        leaves, phase, schedule, transport, codec, False, kernel, buckets,
        faults, tick, res, _leaf_perms(names, layout, 1))
    if ef_residual is None:
        return dict(zip(names, mixed[:-1])), mixed[-1]
    return (dict(zip(names, mixed[:-1])), mixed[-1],
            dict(zip(names, new_res[:-1])))


def mix_push_pull(params: dict, phase: int, schedule: GossipSchedule,
                  transport, codec=None, kernel=None,
                  buckets: int = 1, layout=None) -> dict:
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
                         buckets=buckets,
                         perms=_leaf_perms(names, layout, 0))
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
