"""Shared pieces of the tensor axis's tests (``test_torch_tp.py``,
``test_torch_tp_dist.py``): one small LM whose heads, ``d_ff`` and
vocabulary divide by 4, its algorithms, token batches from a seed, a few
train steps and the eval step, run the same way on the stacked lane (all
tp shards in the test's process, ``parallel/tp.py::StackedTp``) and on
the process lane (one tp shard a gloo process, ``DistTp``)."""

import numpy as np
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel.multihost import (
    host_local_slice)
from stochastic_gradient_push_torch.parallel.wire import get_codec
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd

VOCAB, D, L, H, FF, T, B = 64, 32, 2, 4, 64, 32, 2
STEPS = 3
# sgp_twin: SGP on the gossip kernel lane's CPU twin (interpret), whose
# cross-process start sends over the dp group by the members' global
# ranks; sgp_int8: SGP on the int8 wire at block 8 (every shard of this
# model keeps the reference's blocks); sgp_bf16: SGP computing in bf16
ALGORITHMS = ("sgp", "sgp_twin", "sgp_int8", "sgp_bf16", "osgp",
              "allreduce", "dpsgd", "adpsgd")


def config(tp: int, impl: str = "full", remat: bool = False,
           dtype=torch.float32):
    return TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                             n_heads=H, d_ff=FF, attn_impl=impl,
                             remat=remat, dtype=dtype, tp=tp)


def algorithm(name: str, dp: int, transport):
    if name == "allreduce":
        return talg.all_reduce(transport)
    graph = NPeerDynamicDirectedExponentialGraph(dp, peers_per_itr=1)
    if name == "adpsgd":
        from stochastic_gradient_push_torch.topology import (
            build_pairing_schedule)

        return talg.adpsgd(build_pairing_schedule(graph), transport)
    sched = build_schedule(graph)
    if name == "dpsgd":
        return talg.dpsgd(sched, transport)
    if name == "osgp":
        return talg.osgp(sched, transport, staleness=2)
    if name == "sgp_twin":
        return talg.sgp(sched, transport, gossip_kernel=KernelLane(
            interpret=True, chunk_elems=128))
    if name == "sgp_int8":
        return talg.sgp(sched, transport, wire=get_codec("int8", 8))
    return talg.sgp(sched, transport)   # sgp, sgp_bf16


def batches(dp: int, sp: int, seed: int, steps: int = STEPS) -> list:
    """``steps`` batches of ``[dp, sp, B, T / sp]`` tokens and targets."""
    r = np.random.default_rng(seed)
    return [tuple(r.integers(0, VOCAB, size=(dp, sp, B, T // sp))
                  for _ in range(2)) for _ in range(steps)]


def run(name: str, dp: int, transport, seq, tp, data, impl="full",
        remat=False, dtype=torch.float32) -> dict:
    """``len(data)`` train steps from the seed-0 init over ``data`` (this
    process's rows and sequence shards of it; the tp shards see the
    replica's tokens), then the eval step on the first batch: per step
    each held replica's loss and grad norm, the final params and
    momentum as held (a split leaf ``[R, held, ...]``), the push-sum
    weight, the FIFO's weights, the eval loss and the count of sums over
    the tp shards."""
    if name == "sgp_bf16":
        dtype = torch.bfloat16
    cfg = config(1 if tp is None else tp.size, impl, remat, dtype)
    alg = algorithm(name, dp, transport)
    model = tlm.make_model(cfg)
    tx = sgd(0.9, 1e-4, nesterov=True)
    step = tlm.build_lm_train_step(
        model, alg, tx, LRSchedule(0.5, B, dp, decay_schedule={},
                                   warmup=True),
        itr_per_epoch=2, seq=seq, tp=tp)
    state = tlm.init_lm_state(cfg, alg, tx, len(transport.ranks), seed=0,
                              tp=tp)

    def mine(pair):
        got = host_local_slice({"x": pair[0], "y": pair[1]}, transport,
                               None if seq is None else seq.shards)
        return [torch.from_numpy(got[k] if seq is not None
                                 else got[k][:, 0]).long()
                for k in ("x", "y")]

    out = {}
    for i, pair in enumerate(data):
        state, m = step(state, *mine(pair))
        out[f"loss/{i}"] = m["loss"].detach().numpy()
        out[f"grad_norm/{i}"] = m["grad_norm"].detach().numpy()
    for n, p in state.params.items():
        out[f"params/{n}"] = p.numpy()
    for n, p in state.opt_state.items():
        out[f"momentum/{n}"] = p.numpy()
    out["ps_weight"] = state.gossip.ps_weight.numpy()
    for k, (_, w) in enumerate(state.gossip.in_flight or ()):
        out[f"in_flight/{k}"] = w.numpy()
    ev = tlm.build_lm_eval_step(model, alg, seq, tp)(state, *mine(data[0]))
    out["eval_loss"] = ev["loss"].numpy()
    out["reductions"] = np.array(0 if tp is None else tp.reductions)
    return out
