"""Shared pieces of the sequence axis's process-lane tests
(``test_torch_seq_dist.py``): one small ring LM, its algorithms, token
batches from a seed, a few train steps and the eval step, run the same
way on the stacked lane (in the test's process) and on the process lane
(one sequence shard a gloo process, ``parallel/seq.py::DistSeq``)."""

import numpy as np
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel.multihost import (
    host_local_slice)
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd

VOCAB, D, L, H, FF, T, B = 64, 32, 2, 1, 64, 32, 2
STEPS = 3
# sgp_twin: SGP on the gossip kernel lane's CPU twin (interpret), whose
# cross-process start sends over the dp group by the members' global ranks
ALGORITHMS = ("sgp", "sgp_twin", "osgp", "allreduce")


def config(impl: str = "ring_flash", remat: bool = False):
    return TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                             n_heads=H, d_ff=FF, attn_impl=impl,
                             remat=remat)


def algorithm(name: str, dp: int, transport):
    if name == "allreduce":
        return talg.all_reduce(transport)
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1))
    if name == "osgp":
        return talg.osgp(sched, transport, staleness=2)
    if name == "sgp_twin":
        return talg.sgp(sched, transport, gossip_kernel=KernelLane(
            interpret=True, chunk_elems=128))
    return talg.sgp(sched, transport)


def batches(dp: int, sp: int, seed: int) -> list:
    """``STEPS`` batches of ``[dp, sp, B, T / sp]`` tokens and targets."""
    r = np.random.default_rng(seed)
    return [tuple(r.integers(0, VOCAB, size=(dp, sp, B, T // sp))
                  for _ in range(2)) for _ in range(STEPS)]


def run(name: str, dp: int, transport, seq, data, impl="ring_flash",
        remat=False) -> dict:
    """``STEPS`` train steps from the seed-0 init over ``data`` (this
    process's rows and shards of it), then the eval step on the first
    batch: per step each held replica's loss and grad norm, the final
    params, momentum, push-sum weight and FIFO weights, the eval loss."""
    cfg = config(impl, remat)
    alg = algorithm(name, dp, transport)
    model = tlm.make_model(cfg)
    tx = sgd(0.9, 1e-4, nesterov=True)
    step = tlm.build_lm_train_step(
        model, alg, tx, LRSchedule(0.5, B, dp, decay_schedule={},
                                   warmup=True),
        itr_per_epoch=2, seq=seq)
    state = tlm.init_lm_state(cfg, alg, tx, len(transport.ranks), seed=0)

    def mine(pair):
        got = host_local_slice({"x": pair[0], "y": pair[1]}, transport,
                               seq.shards)
        return [torch.from_numpy(got[k]).long() for k in ("x", "y")]

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
    ev = tlm.build_lm_eval_step(model, alg, seq)(state, *mine(data[0]))
    out["eval_loss"] = ev["loss"].numpy()
    return out
