"""Gossip collectives: the synchronous flat push-sum round and AllReduce.

Port of the synchronous path of ``stochastic_gradient_push_tpu/parallel/
collectives.py`` (``_round_fn:348``, ``gossip_round:618`` for flat
schedules, ``mix_push_sum:812``, ``allreduce_mean:901``).  One round
computes, per rank, ``lo * x + Σ_i recv_i(w_i * x)`` with the schedule's
phase tables: sender multiply → encode → transport → decode-add, edges
folded in order ``i = 0, 1, …``.  The elementwise ops follow the
reference's order and its compiled rounding (XLA fuses ``lo * x +
recv_0`` into one multiply-add, and an int8 decode-add likewise), so the
push-sum weight and the parameters come out bit-equal to the
reference's round on every wire (``tests/test_torch_collectives.py``).

Leaves are **rank-stacked**: dim 0 indexes the ranks this process holds.
The transport is a seam with two lanes:

* :class:`StackedTransport` — all ``W`` ranks in one process, the
  permutation an index gather along dim 0 (the counterpart of the
  reference's virtual-device mesh).  It serves the tests and runs on
  CUDA tensors as well;
* :class:`DistTransport` — one rank per process, each exchange one
  ``batch_isend_irecv`` pair (gloo on CPU, NCCL on GPU): what a
  multi-GPU run under ``torchrun`` uses.

Scalar leaves (per-rank size 1: the push-sum weight) never go through a
codec, so the weight lane stays exact f32.  At world 1 a round returns
its input, as the reference does at ``:764``.

Not ported yet: error feedback, fault masks, the overlap split
(``overlap_launch``, ``PendingShares``), the gossip kernel lane, and the
hierarchical and synthesized rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..topology.schedule import GossipSchedule

__all__ = ["StackedTransport", "DistTransport", "gossip_round",
           "mix_push_sum", "allreduce_mean"]


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


def gossip_round(tree, phase: int, schedule: GossipSchedule, transport,
                 codec=None):
    """One synchronous gossip round over a list of rank-stacked leaves:
    ``lo * x + Σ_i permute_i(w_i * x)`` at ``phase % num_phases``."""
    if transport.world_size != schedule.world_size:
        raise ValueError(
            f"schedule was built for world_size={schedule.world_size} but "
            f"the transport holds world {transport.world_size}")
    leaves = list(tree)
    if schedule.world_size == 1:
        return leaves
    send_codec = _resolve_codec(codec)
    p = phase % schedule.num_phases
    out = list(leaves)
    for i in range(schedule.peers_per_itr):
        dests = schedule.perms[p, i]
        for j, a in enumerate(leaves):
            w_i = _rank_weight(schedule.edge_weights[p, i], transport, a)
            msg = a * w_i.to(a.dtype)
            coded = send_codec is not None and _is_payload(msg)
            if coded:
                wire = tuple(transport.permute(x, dests)
                             for x in send_codec.encode(msg))
            else:
                # exact lane: payloads without a codec and every scalar
                # (ps-weight) leaf, codec or not
                wire = transport.permute(msg, dests)
            # the fold rounds as the reference's compiled round does:
            # edge 0 is one fused multiply-add lo * x + recv, later edges
            # add (an int8 decode-add is itself fused, see wire.py)
            if i == 0:
                recv = send_codec.decode(wire, msg) if coded else wire
                lo = _rank_weight(schedule.self_weight[p], transport, a)
                out[j] = torch.addcmul(recv, a, lo.to(a.dtype))
            elif coded:
                out[j] = send_codec.decode_add(wire, out[j])
            else:
                out[j] = out[j] + wire
    return out


def mix_push_sum(params: dict, ps_weight: torch.Tensor, phase: int,
                 schedule: GossipSchedule, transport, codec=None):
    """Push-sum round: parameters and the push-sum weight ``[R]`` mixed
    jointly, the weight always on the exact lane.  Returns
    ``(params, ps_weight)``."""
    names = list(params)
    mixed = gossip_round([params[n] for n in names] + [ps_weight], phase,
                         schedule, transport, codec=codec)
    return dict(zip(names, mixed[:-1])), mixed[-1]


def allreduce_mean(tree: dict, transport) -> dict:
    """Exact all-reduce mean (the AllReduce baseline's gradient average)."""
    return {n: transport.allreduce_sum(a) / transport.world_size
            for n, a in tree.items()}
