"""Language-model training with gossip data parallelism.

Port of the data-parallel part of ``stochastic_gradient_push_tpu/train/
lm.py``: :func:`lm_loss`, :func:`build_lm_train_step` (with
``grad_accum``), :func:`build_lm_eval_step` and :func:`init_lm_state`.
The step keeps the reference's order exactly::

    pre_step → eval_params → forward/backward → reduce_grads → LR
      → numerator update → post_step → metrics (loss, ppl, lr, grad_norm)

State leaves and token batches are rank-stacked: dim 0 indexes the
ranks this process holds (all ``W`` of them on the stacked transport,
one under ``torch.distributed``).  Each rank's forward and backward runs
``torch.func.functional_call`` of one shared module with that rank's
de-biased parameters; the module's own weights are never used.

``health_axis`` (a transport) adds the consensus health signals after
``post_step``, as ``train/step.py`` does; the step tells the algorithm
the LM's reference layout (the int8 wire's blocks).

Sequence parallelism (the reference's ``(gossip, seq)`` mesh): with a
ring ``attn_impl`` and ``seq`` (``parallel/seq.py``) the batches are
``[R, held, batch, seq_len / sp]``, the ``R`` ranks being the gossip
replicas held here and ``held`` the shards of each held here: all
``sp`` on a :class:`~..parallel.seq.StackedSeq`, this process's one on
a :class:`~..parallel.seq.DistSeq`.  One ``functional_call`` runs over
a replica's held shards; its loss is their mean of each shard's token
mean.  Then ``seq.pmean`` means the loss and the gradients over the
replica's shards (the reference's ``lax.pmean(..., seq)``,
``train/lm.py:368-376, 410-412`` there): across processes one
all-reduce per dtype on the sp group, before the optimizer and the
gossip round; on a stack nothing, autograd having summed the stacked
shards.  Either way the gradient is the reference's seq-psummed
gradient divided by ``sp``, identical on every shard of a replica, so
the grad norm and the health signals need no mean of their own.
``loss``, ``ppl`` and ``grad_norm`` are per replica.

The model computes in its config's ``dtype`` (the reference's
``--precision``: bf16 compute on fp32 parameters, ``models/
transformer.py``); the state (parameters, momentum, the gossip state)
and the loss stay fp32 at any dtype.

The eval step runs each replica's forward on its de-biased parameters
(``algorithm.val_params``: an overlap FIFO folded in first) under
``torch.no_grad``, so the flash attention runs its forward kernel alone;
no gossip, no state update.

Tensor parallelism (the reference's ``(gossip, tp)`` and ``(gossip,
seq, tp)`` meshes): a model of ``cfg.tp`` > 1 and ``tp``
(``parallel/tp.py``: a :class:`~..parallel.tp.StackedTp` holding all
shards, or a :class:`~..parallel.tp.DistTp` one a process).  The state's
split leaves are ``[R, held, *shard]``, its replicated ones ``[R, ...]``
(:func:`init_lm_state` draws the logical params from the seed and places
them); the batches are the replica's, as without tp (the shards see the
same tokens).  The loss is the cross-entropy over the vocabulary split
across ``lm_head``'s shards (``tp.lm_loss``), the grad norm the norm of
the logical leaves (``metrics.global_norm(grads, tp)``); the gossip
round runs on every leaf as it is held, each ``(shard, t)`` index's
slices on its own dp group across processes.

Mixture of experts (a model of ``cfg.moe_experts`` > 0, the
reference's ``train/lm.py:292-414``): the objective is the
cross-entropy plus ``moe_loss_coef`` (0.01) times the mean over MoE
blocks of each block's load-balancing loss (meaned over its routing
groups), ``ppl`` is ``exp`` of the bare cross-entropy, and
``moe_dropped`` the mean over blocks of the dropped fraction; under
``grad_accum`` each microbatch routes under its own capacity.  Expert
parallelism (the reference's ``(gossip, ep)`` and ``(gossip, ep, seq)``
meshes): a model of ``cfg.ep`` > 1 and ``ep`` (``parallel/ep.py``: a
:class:`~..parallel.ep.StackedEp` holding all shards, or a
:class:`~..parallel.ep.DistEp` one a process).  A replica's batches are
``[R, held_ep, batch, seq_len]`` (``[R, held_ep, held_sp, batch,
seq_len / sp]`` with ``seq``), each ep shard its own tokens; one forward
runs over all held shards (the exchange couples them), their batches
folded into one.  Every gradient is the mean over ep shards
(``ep.reduce_grads``), loss, ``ppl`` and ``moe_dropped`` are meaned over
ep, the grad norm is each shard's norm of its own gradients meaned over
ep (``metrics.global_norm(grads, ep=)``), and eval means the
cross-entropy over ep.  :func:`init_lm_state` draws the logical experts
once and a :class:`~..parallel.ep.DistEp` keeps its shard's slice.

MoE under tensor parallelism (the reference's ``(gossip, tp)``,
``(gossip, seq, tp)``, ``(gossip, ep, tp)`` and ``(gossip, ep, seq,
tp)`` meshes): a model of both ``cfg.tp`` and ``cfg.moe_experts``, its
expert stacks split on their F dim (``[R, held_tp, E_held, ...]``); the
objective adds the MoE loss to the vocabulary-parallel cross-entropy,
the gradients are divided by ``sp`` then by ``ep`` as above, and the
grad norm of each ep shard is over the tp-logical leaves (its expert
slice at full F), meaned over ep.

The pipeline-parallel meshes (``--pp``) have a step of their own,
``train/pp.py``, over the stage module of ``models/pipeline.py``.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
from torch.func import functional_call

from ..algorithms.api import GossipAlgorithm
from ..models.convert import (init_params, params_from_jax,
                              reference_layout)
from ..models.transformer import (TransformerConfig, TransformerLM,
                                  check_ep_axis, check_tp_axis)
from ..parallel.ep import check_ep_wire_blocks, shard_experts
from ..parallel.tp import check_wire_blocks, shard_params
from .metrics import global_norm
from .state import TrainState

__all__ = ["lm_loss", "build_lm_train_step", "build_lm_eval_step",
           "init_lm_state", "make_model", "logical_shapes"]


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, written as ``logsumexp -
    target_logit`` as in the reference, in fp32 (fp64 logits stay
    fp64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def make_model(cfg: TransformerConfig) -> TransformerLM:
    """The module the step calls functionally: built on the meta device,
    so it holds no weights of its own."""
    with torch.device("meta"):
        return TransformerLM(cfg)


def _check_seq(model: TransformerLM, seq) -> None:
    if model.cfg.ring != (seq is not None):
        raise ValueError(f"attn_impl {model.cfg.attn_impl!r} with seq "
                         f"{seq!r}: ring and ring_flash run over a "
                         f"sequence axis (a StackedSeq, or a DistSeq "
                         f"across processes), the other attentions without "
                         f"one")


def _fold_ep(x: torch.Tensor, seq) -> torch.Tensor:
    """The held ep shards' batches as one: ``[held, B, T]`` -> ``[held·B,
    T]``, ``[held, held_sp, B, t]`` -> ``[held_sp, held·B, t]``."""
    if seq is None:
        return x.reshape(-1, x.shape[-1])
    return x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[-1])


def _replica_loss(model: TransformerLM, seq, tp, ep, z_r: dict, xs, ys,
                  moe_loss_coef: float = 0.01):
    """One replica's ``(objective, cross-entropy, dropped fraction)``.
    The cross-entropy is its token mean, or with ``seq`` the mean over
    its held shards of each shard's token mean, with ``ep`` over the held
    ep shards' tokens; with ``tp`` over the vocabulary split across the
    tp shards.  A MoE model's objective adds ``moe_loss_coef`` times the
    blocks' mean load-balancing loss; otherwise it is the cross-entropy
    and the dropped fraction None."""
    if ep is not None:
        xs, ys = _fold_ep(xs, seq), _fold_ep(ys, seq)
    aux = [] if model.cfg.moe_experts else None
    logits = functional_call(model, z_r, (xs, seq, tp, ep, aux))
    if tp is not None and seq is None:
        ce = tp.lm_loss(logits, ys)
    elif tp is not None:
        ce = torch.stack([tp.lm_loss([lg[s] for lg in logits], y)
                          for s, y in enumerate(ys)]).mean()
    elif seq is None:
        ce = lm_loss(logits, ys)
    else:
        ce = torch.stack([lm_loss(lg, y) for lg, y in zip(logits, ys)]
                         ).mean()
    if aux is None:
        return ce, ce, None
    # the reference's sum(mean(l) for l in sown) / len(sown)
    lb = sum(l.mean() for l, _ in aux) / len(aux)
    dropped = sum(d.mean() for _, d in aux) / len(aux)
    return ce + moe_loss_coef * lb, ce, dropped.detach()


def build_lm_train_step(model: TransformerLM, algorithm: GossipAlgorithm,
                        tx, lr_schedule, itr_per_epoch: int,
                        grad_accum: int = 1,
                        health_axis=None, seq=None, tp=None, ep=None,
                        moe_loss_coef: float = 0.01) -> typing.Callable:
    """Step ``(state, tokens, targets) -> (state, metrics)`` for token
    batches ``[R, batch, seq_len]``, or ``[R, held, batch, seq_len / sp]``
    with ``seq`` (a ring model's sequence axis), each with the held ep
    shards' dim after ``R`` with ``ep``.  ``grad_accum`` splits the batch
    into that many microbatches whose gradients are summed, then
    divided, as the reference's scan does.  ``health_axis`` (a
    transport) adds the health signals.  ``tp`` is the tensor axis of a
    model of ``cfg.tp`` > 1, ``ep`` the expert axis of one of ``cfg.ep``
    > 1; an int8 wire must keep the reference's blocks on their shards
    (``parallel/tp.py::check_wire_blocks``,
    ``parallel/ep.py::check_ep_wire_blocks``).  ``moe_loss_coef``
    weighs a MoE model's load-balancing loss."""
    from .step import health_metrics

    if grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    _check_seq(model, seq)
    check_tp_axis(model.cfg, tp)
    check_ep_axis(model.cfg, ep)
    codec = getattr(algorithm, "wire", None)
    if codec is not None and codec.blocked:
        if tp is not None:
            check_wire_blocks(logical_shapes(model.cfg), tp.size,
                              codec.block)
        if ep is not None:
            check_ep_wire_blocks(logical_shapes(model.cfg), ep.size,
                                 codec.block)
    layout = reference_layout(model)
    algorithm.bind_layout(layout)
    moe = model.cfg.moe_experts > 0

    def rank_grads(z_r: dict, toks, tgts):
        # the batch dim: after the held ep and sequence shards' dims
        batch_dim = toks.ndim - 2
        if toks.shape[batch_dim] % grad_accum:
            raise ValueError(f"batch {toks.shape[batch_dim]} not divisible "
                             f"by grad_accum {grad_accum}")
        z_r = {n: p.detach().requires_grad_(True) for n, p in z_r.items()}
        g_sum, sums = None, None
        for xs, ys in zip(toks.chunk(grad_accum, batch_dim),
                          tgts.chunk(grad_accum, batch_dim)):
            loss, ce, dropped = _replica_loss(model, seq, tp, ep, z_r, xs,
                                              ys, moe_loss_coef)
            g = torch.autograd.grad(loss, list(z_r.values()))
            got = ([loss.detach(), ce.detach(), dropped] if moe
                   else [loss.detach()])
            if g_sum is None:
                g_sum, sums = list(g), got
            else:
                g_sum = [a + b for a, b in zip(g_sum, g)]
                sums = [a + b for a, b in zip(sums, got)]
        if grad_accum > 1:
            g_sum = [g / grad_accum for g in g_sum]
            sums = [x / grad_accum for x in sums]
        return dict(zip(z_r, g_sum)), sums

    def train_step(state: TrainState, tokens, targets):
        params, gstate = algorithm.pre_step(state.params, state.gossip)
        z = algorithm.eval_params(params, gstate)

        per_rank = [rank_grads({n: p[r] for n, p in z.items()},
                               tokens[r], targets[r])
                    for r in range(tokens.shape[0])]
        grads = {n: torch.stack([g[n] for g, _ in per_rank]) for n in z}
        # the loss (a MoE model's cross-entropy and dropped fraction too),
        # one a replica
        scalars = [torch.stack(x) for x in zip(*(s for _, s in per_rank))]
        k = len(scalars)
        if seq is not None:
            out = seq.pmean([*scalars, *grads.values()])
            scalars, grads = out[:k], dict(zip(grads, out[k:]))
        if ep is not None:
            grads = ep.reduce_grads(grads)
            scalars = ep.pmean(scalars)
        loss = scalars[0]
        ce = scalars[1] if moe else loss
        grads = algorithm.reduce_grads(grads)

        step = state.step
        lr = lr_schedule(step // itr_per_epoch, step % itr_per_epoch,
                         itr_per_epoch)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        params = {n: p - float(lr) * updates[n] for n, p in params.items()}
        params, gstate = algorithm.post_step(params, gstate)

        metrics = {"loss": loss, "ppl": torch.exp(ce), "lr": lr,
                   "grad_norm": global_norm(grads, tp, ep)}
        if moe:
            metrics["moe_dropped"] = scalars[2]
        if health_axis is not None:
            metrics.update(health_metrics(params, grads, gstate,
                                          health_axis, layout))
        return TrainState(step=step + 1, params=params,
                          opt_state=opt_state, gossip=gstate), metrics

    return train_step


def build_lm_eval_step(model: TransformerLM, algorithm: GossipAlgorithm,
                       seq=None, tp=None, ep=None) -> typing.Callable:
    """Eval ``(state, tokens, targets) -> {"loss", "ppl"}``, one value a
    held replica, for the train step's batch shapes: each replica's
    forward on its de-biased parameters under ``torch.no_grad``, then
    :func:`lm_loss` (with ``seq``, the mean over its shards, across
    processes by ``seq.pmean``; with ``tp``, over the vocabulary split
    across the tp shards; with ``ep``, the mean over the ep shards'
    tokens).  The bare cross-entropy, no MoE loss.  No gossip, no state
    update (the reference's ``build_lm_eval_step``)."""
    _check_seq(model, seq)
    check_tp_axis(model.cfg, tp)
    check_ep_axis(model.cfg, ep)

    def eval_step(state: TrainState, tokens, targets) -> dict:
        with torch.no_grad():
            z = algorithm.val_params(state.params, state.gossip)
            loss = torch.stack([
                _replica_loss(model, seq, tp, ep,
                              {n: p[r] for n, p in z.items()},
                              tokens[r], targets[r])[1]
                for r in range(tokens.shape[0])])
            if seq is not None:
                loss = seq.pmean([loss])[0]
            if ep is not None:
                loss = ep.pmean([loss])[0]
        return {"loss": loss, "ppl": torch.exp(loss)}

    return eval_step


def logical_shapes(cfg: TransformerConfig) -> dict:
    """Each parameter's logical per-replica shape (as at tp 1)."""
    return {n: tuple(p.shape) for n, p in
            make_model(dataclasses.replace(cfg, tp=1)).named_parameters()}


def init_lm_state(cfg: TransformerConfig, algorithm: GossipAlgorithm, tx,
                  world: int, seed: int = 0,
                  device: str | torch.device = "cpu",
                  tp=None, ep=None) -> TrainState:
    """Fresh state for ``world`` held ranks: every rank starts from the
    same parameters, drawn from ``seed`` with the flax init recipe
    (``models/convert.py::init_params``), zero momentum, ps-weight 1.
    At ``cfg.ep`` > 1 every expert is drawn once and the ep shards held
    keep theirs (``parallel/ep.py::shard_experts``: all on a stack); at
    ``cfg.tp`` > 1 the result is placed for the shards ``tp`` holds
    (``parallel/tp.py::shard_params``), as the reference's
    ``init_lm_state_tp`` and ``init_lm_state_ep`` place their draws: an
    expert stack then holds each held ``(e, t)`` slice, ep on its expert
    dim and tp on its F dim."""
    check_tp_axis(cfg, tp)
    check_ep_axis(cfg, ep)
    one = params_from_jax(init_params(dataclasses.replace(cfg, tp=1), seed))
    params = {n: p.to(device)[None].expand(world, *p.shape).clone()
              for n, p in one.items()}
    if ep is not None and len(ep.shards) < ep.size:
        params = shard_experts(params, ep.size, ep.shards)
    if tp is not None:
        params = shard_params(params, cfg.tp, tp.shards)
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      gossip=algorithm.init(params))

