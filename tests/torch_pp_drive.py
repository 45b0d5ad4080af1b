"""Shared pieces of the pipeline axis's tests (``test_torch_pp.py``,
``test_torch_pp_dist.py``): small LMs at the reference's
``tests/test_pipeline.py`` sizes (d32, h4, ff64, vocab 64, T16; dense at
L4, MoE with 4 experts on every block at L2), their algorithms, token
batches from a seed, a few train steps and the eval step, run the same
way on the stacked lane (every stage in the test's process,
``parallel/pipeline.py::StackedPipe``) and on the process lane (one
``(stage, ep shard, sequence shard)`` a gloo process, ``DistPipe`` beside
``DistEp`` and ``DistSeq``); and the reference's pipelined step on its
CPU meshes."""

import numpy as np
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel.wire import get_codec
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import pp as tpp
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd

VOCAB, D, H, FF, T, E = 64, 32, 4, 64, 16, 4
N_MICRO, MB = 2, 2
B = N_MICRO * MB
STEPS = 2
# sgp_int8: SGP on the int8 wire at block 64 (a stage's leaves, [L/pp,
# ...] at two layers a stage, keep the reference's blocks, which span the
# layers); sgp_twin: SGP on the gossip kernel lane's CPU twin
ALGORITHMS = ("sgp", "sgp_int8", "sgp_twin", "osgp", "dpsgd", "allreduce")


def config(n_layers: int = 4, sp: int = 1, ep: int = 1, moe: bool = False,
           impl: str | None = None, remat: bool = False,
           dtype=torch.float32, cf: float = 1.25) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=VOCAB, d_model=D, n_layers=n_layers, n_heads=H, d_ff=FF,
        attn_impl=impl or ("ring" if sp > 1 else "full"), remat=remat,
        dtype=dtype, moe_experts=E if moe else 0, moe_every=1,
        moe_capacity_factor=cf, ep=ep)


def algorithm(name: str, dp: int, transport):
    if name == "allreduce":
        return talg.all_reduce(transport)
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1))
    if name == "osgp":
        return talg.osgp(sched, transport, staleness=2)
    if name == "dpsgd":
        return talg.dpsgd(sched, transport)
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


def local(batch, rows, ep, sp: int, ep_shards=None,
          seq_shards=None) -> torch.Tensor:
    """The rows (and ep and sequence shards, default all) held here of a
    ``[dp, ep, sp, B, t]`` batch, as the step takes them: no ep dim
    without an expert axis, no sequence dim at sp 1."""
    x = batch[np.asarray(rows)]
    if ep_shards is not None:
        x = x[:, np.asarray(ep_shards)]
    if seq_shards is not None:
        x = x[:, :, np.asarray(seq_shards)]
    if sp == 1:
        x = x[:, :, 0]
    if ep is None:
        x = x[:, 0]
    return torch.from_numpy(np.ascontiguousarray(x)).long()


def lr_schedule(dp: int, ep: int) -> LRSchedule:
    return LRSchedule(0.5, B, dp * ep, decay_schedule={}, warmup=True)


def run(name: str, dp: int, transport, pipe, data, n_layers: int = 4,
        sp: int = 1, seq=None, ep=None, moe: bool = False,
        impl: str | None = None, remat: bool = False, start=None,
        n_micro: int = N_MICRO, dtype=torch.float32, cf: float = 1.25,
        coef: float = 0.01) -> dict:
    """``len(data)`` train steps over ``pipe``'s stages from the seed-0
    init (or ``start``, a rank-stacked state as held), then the eval step
    on the first batch: per step each held replica's loss, ppl,
    moe_dropped and grad norm, the final params and momentum as held, the
    push-sum weight, the eval loss, the pipe's hand-offs and (with
    ``seq`` or ``ep``) the shifts and exchanges with their bytes."""
    cfg = config(n_layers, sp, 1 if ep is None else ep.size, moe, impl,
                 remat, dtype, cf)
    alg = algorithm(name, dp, transport)
    model = tpp.make_pp_model(cfg, pipe.size)
    tx = sgd(0.9, 1e-4, nesterov=True)
    step = tpp.build_pp_train_step(
        model, alg, tx, lr_schedule(dp, cfg.ep), itr_per_epoch=2,
        pipe=pipe, n_micro=n_micro, seq=seq, ep=ep, moe_loss_coef=coef)
    state = (start if start is not None else tpp.init_pp_state(
        cfg, alg, tx, len(transport.ranks), pipe.size, stages=pipe.stages,
        seed=0, ep=ep))

    def mine(pair):
        return [local(a, transport.ranks, ep, sp,
                      None if ep is None else ep.shards,
                      None if seq is None else seq.shards) for a in pair]

    out = {}
    for i, pair in enumerate(data):
        state, m = step(state, *mine(pair))
        for k in ("loss", "ppl", "moe_dropped", "grad_norm"):
            if k in m:
                out[f"{k}/{i}"] = m[k].detach().numpy()
    for n, p in state.params.items():
        out[f"params/{n}"] = p.numpy()
    for n, p in state.opt_state.items():
        out[f"momentum/{n}"] = p.numpy()
    out["ps_weight"] = state.gossip.ps_weight.numpy()
    ev = tpp.build_pp_eval_step(model, alg, pipe, n_micro, seq, ep)(
        state, *mine(data[0]))
    out["eval_loss"] = ev["loss"].numpy()
    out["hand_offs"] = np.array(getattr(pipe, "hand_offs", 0))
    # the sequence and expert axes' counters, where they exist
    for ax, keys in ((seq, ("shifts", "shift_bytes")),
                     (ep, ("exchanges", "exchange_bytes"))):
        if ax is not None:
            out.update({k: np.array(getattr(ax, k, 0)) for k in keys})
    return out


def flat_run(name: str, dp: int, data, n_layers: int = 4, sp: int = 1,
             ep: int = 1, moe: bool = False, impl: str | None = None,
             cf: float = 1.25, coef: float = 0.01) -> dict:
    """:func:`run`'s steps on the non-pipelined step (``train/lm.py``,
    pp 1) on the stacked lane, from the same seed-0 logical model: the
    losses and the final params as the reference's ``TransformerLM``
    tree."""
    from stochastic_gradient_push_torch.models.convert import params_to_jax
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.ep import StackedEp
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.train import lm as tlm

    cfg = config(n_layers, sp, ep, moe, impl, cf=cf)
    alg = algorithm(name, dp, StackedTransport(dp))
    tx = sgd(0.9, 1e-4, nesterov=True)
    seq = StackedSeq(sp) if cfg.ring else None
    ep_ax = StackedEp(ep) if ep > 1 else None
    step = tlm.build_lm_train_step(tlm.make_model(cfg), alg, tx,
                                   lr_schedule(dp, ep), itr_per_epoch=2,
                                   seq=seq, ep=ep_ax, moe_loss_coef=coef)
    state = tlm.init_lm_state(cfg, alg, tx, dp, seed=0, ep=ep_ax)
    out = {}
    for i, pair in enumerate(data):
        xs = [local(a, range(dp), ep_ax, sp) for a in pair]
        state, m = step(state, *xs)
        for k in ("loss", "ppl", "moe_dropped"):
            if k in m:
                out[f"{k}/{i}"] = m[k].numpy()
    out["params"] = params_to_jax(state.params)
    return out


def jax_run(dp: int, pp: int, ep: int, sp: int, data, n_layers: int = 4,
            moe: bool = False, name: str = "sgp", block: int = 64,
            remat: bool = False, with_eval: bool = True):
    """The reference's pipelined step and eval step on its CPU mesh
    (``make_dp_pp_mesh``, ``make_dp_pp_sp_mesh``, ``make_dp_pp_ep_mesh``,
    ``make_dp_pp_ep_sp_mesh``, as its CLI picks them, ``run/gossip_lm.py:
    413-425`` there), from the seed-0 logical model of ``models/
    convert.py::init_params`` placed as the reference's ``init_pp_state``
    places its own draw (``pp_state_specs``; drawing that takes a compile
    of its own).  Returns its start state, end state, each step's
    metrics and (``with_eval``) the eval metrics of the end state on the
    first batch (host arrays)."""
    import jax
    from jax.sharding import NamedSharding

    from stochastic_gradient_push_tpu import algorithms as jalg
    from stochastic_gradient_push_tpu.models import PipelineStageLM
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.parallel.wire import get_codec as jcodec
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import LRSchedule as JLR
    from stochastic_gradient_push_tpu.train import sgd as jsgd
    from stochastic_gradient_push_tpu.train.lm import EP_AXIS, SEQ_AXIS
    from stochastic_gradient_push_tpu.train.pp import (
        build_pp_eval_step, build_pp_train_step, make_dp_pp_ep_mesh,
        make_dp_pp_ep_sp_mesh, make_dp_pp_mesh, make_dp_pp_sp_mesh,
        pp_state_specs, shard_pp_eval_step, shard_pp_train_step)
    from stochastic_gradient_push_tpu.train.state import TrainState
    from stochastic_gradient_push_tpu.train.step import replicate_state
    from stochastic_gradient_push_torch.models.convert import (
        init_params, pipeline_tree)

    seq_axis = SEQ_AXIS if sp > 1 else None
    ep_axis = EP_AXIS if ep > 1 else None
    cfg = JConfig(vocab_size=VOCAB, d_model=D, n_layers=n_layers,
                  n_heads=H, d_ff=FF, max_len=T,
                  attn_impl="ring" if sp > 1 else "full",
                  seq_axis=seq_axis, moe_experts=E if moe else 0,
                  moe_every=1, ep_axis=ep_axis, remat=remat)
    model = PipelineStageLM(cfg, n_local_layers=n_layers // pp)
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
    if sp > 1 and ep > 1:
        mesh = make_dp_pp_ep_sp_mesh(dp, pp, ep, sp)
    elif sp > 1:
        mesh = make_dp_pp_sp_mesh(dp, pp, sp)
    elif ep > 1:
        mesh = make_dp_pp_ep_mesh(dp, pp, ep)
    else:
        mesh = make_dp_pp_mesh(dp, pp)
    one = pipeline_tree(init_params(config(n_layers, moe=moe), 0))
    state = TrainState(
        step=np.zeros((dp,), np.int32), params=replicate_state(one, dp),
        batch_stats={}, opt_state=replicate_state(tx.init(one), dp),
        gossip=replicate_state(alg.init(one), dp))
    specs = pp_state_specs(state, ep_axis=ep_axis)
    state = jax.device_put(state, jax.tree.map(
        lambda sp_: NamedSharding(mesh, sp_), specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    fn = shard_pp_train_step(build_pp_train_step(model, alg, tx, lrs, 2),
                             mesh, specs, seq_axis=seq_axis,
                             ep_axis=ep_axis)
    ev = shard_pp_eval_step(build_pp_eval_step(model, alg), mesh, specs,
                            seq_axis=seq_axis, ep_axis=ep_axis)

    def shape(a):
        # [dp, ep, sp, B, t] -> [dp, ep?, sp?, M, b, t]
        a = a.reshape(*a.shape[:3], N_MICRO, MB, a.shape[-1])
        if sp == 1:
            a = a[:, :, 0]
        if ep == 1:
            a = a[:, 0]
        return a

    start = jax.device_get(state)
    metrics = []
    for toks, tgts in data:
        state, m = fn(state, shape(toks), shape(tgts))
        metrics.append(jax.device_get(m))
    evm = (jax.device_get(ev(state, shape(data[0][0]), shape(data[0][1])))
           if with_eval else None)
    return start, jax.device_get(state), metrics, evm


def stacked_start(start, pp: int, device="cpu"):
    """The reference's start state on the stacked lane (every stage)."""
    return train_state_from_jax(start, device, pp=pp)
