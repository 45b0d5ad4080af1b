"""Shared pieces of the expert axis's tests (``test_torch_moe.py``,
``test_torch_ep_lm.py``, ``test_torch_ep_dist.py``): one small MoE LM
(the reference's ``tests/test_expert_parallel_lm.py`` sizes: d32, L2,
h4, ff32, 8 experts on every second block), its algorithms, token
batches from a seed, a few train steps and the eval step, run the same
way on the stacked lane (all ep shards in the test's process,
``parallel/ep.py::StackedEp``) and on the process lane (one ep shard a
gloo process, ``DistEp``); and the reference's step on its CPU mesh."""

import numpy as np
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel.tp import shard_state
from stochastic_gradient_push_torch.parallel.wire import get_codec
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd

VOCAB, D, L, H, FF, E, T, B = 64, 32, 2, 4, 32, 8, 32, 2
STEPS = 2
# sgp_int8: SGP on the int8 wire at block 64 (an expert shard's slice,
# E/ep · 32 · 32 elements, keeps the reference's blocks); sgp_twin: SGP
# on the gossip kernel lane's CPU twin
ALGORITHMS = ("sgp", "sgp_int8", "sgp_twin", "osgp", "allreduce")


def config(ep: int = 1, impl: str = "full", remat: bool = False,
           dtype=torch.float32, cf: float = 1.25, experts: int = E,
           tp: int = 1, ff: int = FF):
    return TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                             n_heads=H, d_ff=ff, attn_impl=impl,
                             remat=remat, dtype=dtype, moe_experts=experts,
                             moe_every=2, moe_capacity_factor=cf, ep=ep,
                             tp=tp)


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
    if name == "sgp_int8":
        return talg.sgp(sched, transport, wire=get_codec("int8", 64))
    return talg.sgp(sched, transport)


def batches(dp: int, ep: int, sp: int, seed: int,
            steps: int = STEPS) -> list:
    """``steps`` batches of ``[dp, ep, sp, B, T / sp]`` tokens and
    targets (each ep shard its own tokens)."""
    r = np.random.default_rng(seed)
    return [tuple(r.integers(0, VOCAB, size=(dp, ep, sp, B, T // sp))
                  for _ in range(2)) for _ in range(steps)]


def local(batch, rows, ep_shards, sp: int, seq_shards=None) -> torch.Tensor:
    """The rows, ep shards and sequence shards (default all) held here of
    a ``[dp, ep, sp, B, t]`` batch, as the step takes them (no sequence
    dim at sp 1)."""
    x = batch[np.asarray(rows)][:, np.asarray(ep_shards)]
    if sp > 1 and seq_shards is not None:
        x = x[:, :, np.asarray(seq_shards)]
    return torch.from_numpy(np.ascontiguousarray(
        x if sp > 1 else x[:, :, 0])).long()


def run(name: str, dp: int, transport, ep, data, sp: int = 1, seq=None,
        impl: str = "full", remat: bool = False, grad_accum: int = 1,
        cf: float = 1.25, tp=None, experts: int = E, ff: int = FF,
        start=None) -> dict:
    """``len(data)`` train steps from the seed-0 init (or ``start``, a
    rank-stacked state of logical leaves, on a stacked lane) over
    ``data``, then the eval step on the first batch: per step each held
    replica's loss, ppl, moe_dropped and grad norm, the final params and
    momentum as held, the push-sum weight, the eval loss and the count of
    exchanges (with ``tp``, of the tp sums; across processes, of the
    ring shifts)."""
    cfg = config(1 if ep is None else ep.size, impl, remat, cf=cf,
                 experts=experts, tp=1 if tp is None else tp.size, ff=ff)
    alg = algorithm(name, dp, transport)
    model = tlm.make_model(cfg)
    tx = sgd(0.9, 1e-4, nesterov=True)
    step = tlm.build_lm_train_step(
        model, alg, tx, LRSchedule(0.5, B, dp * cfg.ep, decay_schedule={},
                                   warmup=True),
        itr_per_epoch=2, grad_accum=grad_accum, seq=seq, tp=tp, ep=ep)
    state = tlm.init_lm_state(cfg, alg, tx, len(transport.ranks), seed=0,
                              tp=tp, ep=ep)
    if start is not None:
        # a stacked lane holds every replica and expert: only tp places
        state = start if tp is None else shard_state(start, tp.size)
    shards = (0,) if ep is None else ep.shards
    seq_shards = range(sp) if seq is None else seq.shards

    def mine(pair):
        got = [local(a, transport.ranks, shards, sp, seq_shards)
               for a in pair]
        return got if ep is not None else [g[:, 0] for g in got]

    out = {}
    for i, pair in enumerate(data):
        state, m = step(state, *mine(pair))
        for k in ("loss", "ppl", "moe_dropped", "grad_norm"):
            out[f"{k}/{i}"] = m[k].detach().numpy()
    for n, p in state.params.items():
        out[f"params/{n}"] = p.numpy()
    for n, p in state.opt_state.items():
        out[f"momentum/{n}"] = p.numpy()
    out["ps_weight"] = state.gossip.ps_weight.numpy()
    ev = tlm.build_lm_eval_step(model, alg, seq, tp, ep)(state,
                                                         *mine(data[0]))
    out["eval_loss"] = ev["loss"].numpy()
    out["exchanges"] = np.array(0 if ep is None else ep.exchanges)
    if tp is not None:
        out["reductions"] = np.array(tp.reductions)
    if hasattr(seq, "shifts"):
        out["shifts"] = np.array(seq.shifts)
    return out


def jax_run(dp: int, ep: int, sp: int, data, name: str = "sgp",
            grad_accum: int = 1, cf: float = 1.25, tp: int = 1,
            experts: int = E, ff: int = FF, block: int = 64):
    """The reference's MoE step on its CPU mesh: ``(gossip, ep)`` at sp
    1, ``(gossip, ep, seq)`` with ring attention at sp > 1 (``ep`` 1: the
    flat or ``(gossip, seq)`` mesh); at ``tp`` > 1 the mesh gains its auto
    ``tp`` axis (``make_dp_ep_tp_mesh``, ``make_dp_ep_sp_tp_mesh``,
    ``make_dp_tp_mesh``, ``make_dp_sp_tp_mesh``), as its CLI picks it
    (``run/gossip_lm.py:426-441,638-662`` there).  ``block`` is the int8
    wire's.  Returns its start state, end state and each step's metrics
    (host arrays)."""
    import jax

    from stochastic_gradient_push_tpu import algorithms as jalg
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.parallel.wire import get_codec as jcodec
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import LRSchedule as JLR
    from stochastic_gradient_push_tpu.train import sgd as jsgd
    from stochastic_gradient_push_tpu.train.lm import (
        EP_AXIS, SEQ_AXIS, build_lm_train_step, ep_state_specs,
        init_lm_state, init_lm_state_ep, init_lm_state_tp,
        make_dp_ep_mesh, make_dp_ep_sp_mesh, make_dp_ep_sp_tp_mesh,
        make_dp_ep_tp_mesh, make_dp_sp_mesh, make_dp_sp_tp_mesh,
        make_dp_tp_mesh, shard_lm_train_step)

    seq_axis = SEQ_AXIS if sp > 1 else None
    ep_axis = EP_AXIS if ep > 1 else None
    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                        d_ff=ff, max_len=T,
                        attn_impl="ring" if sp > 1 else "full",
                        seq_axis=seq_axis, moe_experts=experts, moe_every=2,
                        moe_capacity_factor=cf, ep_axis=ep_axis))
    sched = jbuild(JGraph(dp, peers_per_itr=1))
    if name == "allreduce":
        alg = jalg.all_reduce(GOSSIP_AXIS)
    elif name == "sgp_int8":
        alg = jalg.sgp(sched, GOSSIP_AXIS, wire=jcodec("int8", block))
    else:
        alg = jalg.sgp(sched, GOSSIP_AXIS)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lrs = JLR(ref_lr=0.5, batch_size=B, world_size=dp * ep,
              decay_schedule={}, warmup=True)
    step = build_lm_train_step(model, alg, tx, lrs, itr_per_epoch=2,
                               seq_axis=seq_axis, ep_axis=ep_axis,
                               grad_accum=grad_accum)
    auto = tp > 1
    if ep > 1:
        if auto:
            mesh = (make_dp_ep_sp_tp_mesh(dp, ep, sp, tp) if sp > 1
                    else make_dp_ep_tp_mesh(dp, ep, tp))
        else:
            mesh = (make_dp_ep_sp_mesh(dp, ep, sp) if sp > 1
                    else make_dp_ep_mesh(dp, ep))
        state = init_lm_state_ep(model, mesh, alg, tx, dp=dp, ep=ep,
                                 batch_size=B, seq_len=T, seed=0, sp=sp)
        fn = shard_lm_train_step(step, mesh, seq_axis=seq_axis,
                                 state_specs=ep_state_specs(state),
                                 ep_axis=EP_AXIS, tp=auto)
    elif auto and sp == 1:
        mesh = make_dp_tp_mesh(dp, tp)
        state = init_lm_state_tp(model, mesh, alg, tx, dp=dp, batch_size=B,
                                 seq_len=T, seed=0)
        fn = shard_lm_train_step(step, mesh, seq_axis=None, tp=True)
    else:
        mesh = (make_dp_sp_tp_mesh(dp, sp, tp) if auto
                else make_dp_sp_mesh(dp, sp))
        state = init_lm_state(model, mesh, alg, tx, dp=dp, sp=sp,
                              batch_size=B, block_len=T // sp, seed=0,
                              seq_axis=seq_axis)
        fn = shard_lm_train_step(step, mesh, seq_axis=seq_axis, tp=auto)
    start = jax.device_get(state)
    metrics = []
    for toks, tgts in data:
        if ep == 1:
            toks, tgts = toks[:, 0], tgts[:, 0]
        if sp == 1:
            toks, tgts = toks[..., 0, :, :], tgts[..., 0, :, :]
        state, m = fn(state, toks, tgts)
        metrics.append(jax.device_get(m))
    return start, jax.device_get(state), metrics
