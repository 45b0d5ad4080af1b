"""Pipeline-parallel LM training: gossip data parallelism × GPipe stages.

Port of ``stochastic_gradient_push_tpu/train/pp.py``: the ``(gossip,
pipe)``, ``(gossip, pipe, seq)``, ``(gossip, pipe, ep)`` and ``(gossip,
pipe, ep, seq)`` meshes' state (:func:`init_pp_state`), train step
(:func:`build_pp_train_step`) and eval step (:func:`build_pp_eval_step`).

**Layout.**  A replica's layer stack is cut into ``pp`` stages, stage
``s`` holding layers ``[s·L/pp, (s+1)·L/pp)`` (``models/pipeline.py``).
The state's stage leaves (``stack.<leaf>``, params and their momentum
and gossip mirrors) are ``[R, held_pp, L/pp, ...]``: ``held_pp`` the
stages this process holds, all ``pp`` on a :class:`~..parallel.pipeline.
StackedPipe`, one on a :class:`~..parallel.pipeline.DistPipe` (as a tp
shard is held, ``parallel/tp.py``); under ep an expert stack's E dim
comes after, all experts on a stack and ``E/ep`` on a
:class:`~..parallel.ep.DistEp` (a process's ``(stage, e)`` block ``[R, 1,
L/pp, E/ep, ...]``).  ``embed``, ``ln_f`` and
``lm_head`` are replicated over the stages, ``[R, ...]``: one copy on a
stack, one a stage process across processes, where each stage's copy
gossips on its own dp group and every copy gets the same summed
gradient, so they stay equal.  The batches are the non-pipelined step's
(``train/lm.py``): ``[R, (held_ep,) (held_sp,) batch, seq_len / sp]``;
microbatch ``m`` is rows ``[m·b, (m+1)·b)`` of the batch dim, ``b =
batch / n_micro`` (the reference's ``shape_batch``).

**The step** (the reference's ``build_pp_train_step``, ``train/pp.py:
246-361`` there), per held replica: stage 0 embeds every microbatch,
``parallel/pipeline.py::run_schedule`` runs the ticks, the last stage
applies the head and the cross-entropy over all ``n_micro`` microbatches
(the mean over its held sequence shards with ``seq``); a MoE model adds
``moe_loss_coef · Σ lb / (n_micro · L)``, its blocks routing each
microbatch under its own capacity, and reports ``moe_dropped = Σ dropped
/ (n_micro · L)``.  The replicated leaves' gradients are summed over the
stages (``pipe.sum_stages``: autograd on a stack, one all-reduce on the
pipe group across processes, with the loss scalars), the stack's stay
stage-local; then ``/ sp`` (``seq.pmean``) and ``/ ep``
(``ep.reduce_grads``) as ``train/lm.py`` does, ``reduce_grads``, the LR,
the update and ``post_step``.  ``grad_norm`` is the reference's quirk:
each stage's norm of the leaves it holds (the replicated ones counted on
every stage, and its own stack), meaned over the stages, then over the
ep shards (:func:`pp_global_norm`), not the logical model's norm.

:func:`build_pp_eval_step` runs the de-biased parameters through the
schedule under ``no_grad`` and returns the bare cross-entropy, summed
over the stages (the last one's), meaned over seq and ep.
"""

from __future__ import annotations

import typing

import torch

from ..algorithms.api import GossipAlgorithm
from ..models.convert import (init_params, params_from_jax, pipeline_tree,
                              reference_layout)
from ..models.pipeline import PipelineStageLM, check_pp_config
from ..models.transformer import TransformerConfig, check_ep_axis
from ..parallel.ep import is_expert
from ..parallel.pipeline import DistPipe, run_schedule
from .lm import _check_seq, _fold_ep, lm_loss
from .state import TrainState

__all__ = ["STACK", "is_stage", "make_pp_model", "init_pp_state",
           "build_pp_train_step", "build_pp_eval_step", "pp_global_norm",
           "check_pp_wire_blocks"]

STACK = "stack."


def is_stage(name: str) -> bool:
    """Whether the port's leaf ``name`` is a stage (stack) leaf."""
    return name.startswith(STACK)


def make_pp_model(cfg: TransformerConfig, pp: int) -> PipelineStageLM:
    """The stage module the step calls functionally, on the meta device:
    ``cfg.n_layers / pp`` layers a stage."""
    if pp < 1 or cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp}")
    with torch.device("meta"):
        return PipelineStageLM(cfg, cfg.n_layers // pp)


def check_pp_wire_blocks(model: PipelineStageLM, held_pp: int, ep: int,
                         block: int, held_ep: int | None = None) -> None:
    """``ValueError`` naming the first stage leaf whose int8 blocks would
    not be the reference's.  The reference blocks each stage's leaf
    ``[L/pp, ...]`` (under ep its ``[L/pp, E/ep, ...]`` slice) on its
    own; a rank of a stacked state holds ``held_pp`` stages side by side,
    blocked as the reference's exactly when a stage's leaf (as held: one
    ep slice of an expert stack where ``held_ep`` is 1) is a multiple of
    ``block`` elements, and a stacked expert stack's ep slices (``held_ep``
    of them, default all ``ep``) are runs of its flattening only at one
    layer a stage.  One stage and one ep slice a process hold the
    reference's own block unit."""
    held_ep = ep if held_ep is None else held_ep
    for n, p in model.named_parameters():
        if not is_stage(n):
            continue
        size = p.numel()
        if ep > 1 and is_expert(n) and held_ep == 1:
            size //= ep
        if held_pp > 1 and size % block:
            raise ValueError(
                f"--wire_dtype int8 with --pp: {n}'s stage holds {size} "
                f"elements, not a multiple of --wire_block {block}, so "
                f"the stacked stages' int8 blocks would not be the "
                f"reference's")
        if ep > 1 and is_expert(n) and held_ep > 1:
            if model.n_local_layers > 1:
                raise ValueError(
                    f"--wire_dtype int8 with --pp and --ep: {n}'s ep "
                    f"slices interleave over its {model.n_local_layers} "
                    f"layers a stage, so its int8 blocks would not be the "
                    f"reference's (one layer a stage keeps them)")
            if (size // ep) % block:
                raise ValueError(
                    f"--wire_dtype int8 with --ep {ep}: {n}'s shard has "
                    f"{size // ep} elements, not a multiple of --wire_block "
                    f"{block}, so its int8 blocks would not be the "
                    f"reference's")


def init_pp_state(cfg: TransformerConfig, algorithm: GossipAlgorithm, tx,
                  world: int, pp: int, stages=None, seed: int = 0,
                  device: str | torch.device = "cpu",
                  ep=None) -> TrainState:
    """Fresh state for ``world`` held ranks of ``pp`` stages, holding
    ``stages`` (default all) and the experts of ``ep``'s held shards (all
    on a stack): the logical ``L``-layer model drawn once from ``seed``
    with the flax init recipe (``models/convert.py::init_params``: the
    initialisers' distributions, not their bits), each held ``(stage,
    e)`` block placed, zero momentum, ps-weight 1."""
    check_pp_config(cfg)
    ep_shards = (ep.shards if ep is not None and len(ep.shards) < ep.size
                 else None)
    one = params_from_jax(pipeline_tree(init_params(cfg, seed)),
                          ep=cfg.ep, ep_shards=ep_shards, pp=pp,
                          stages=stages)
    params = {n: p.to(device)[None].expand(world, *p.shape).clone()
              for n, p in one.items()}
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      gossip=algorithm.init(params))


def _positions(model: PipelineStageLM, seq, t: int, device):
    pos = torch.arange(t, device=device)
    if model.cfg.ring:
        # each held sequence shard at its global offset
        pos = seq.index(device)[:, None] * t + pos
    return pos


def _micro(x: torch.Tensor, n_micro: int, ep, seq) -> torch.Tensor:
    """``[(held_ep,) (held_sp,) batch, t]`` -> ``[n_micro, ...]``, each
    microbatch's held ep shards folded into its batch dim as the model
    takes them."""
    dim = x.dim() - 2
    if x.shape[dim] % n_micro:
        raise ValueError(f"batch {x.shape[dim]} not divisible by n_micro "
                         f"{n_micro}")
    parts = x.chunk(n_micro, dim)
    if ep is not None:
        parts = [_fold_ep(p, seq) for p in parts]
    return torch.stack(parts)


def _stage_loss(model: PipelineStageLM, seq, rep: dict, hidden: dict,
                ys: torch.Tensor) -> torch.Tensor:
    """The cross-entropy of the last stage's outputs over every
    microbatch (the mean over the held sequence shards with ``seq``)."""
    logits = model.head(rep, torch.stack([hidden[m]
                                          for m in range(len(hidden))]))
    if seq is None:
        return lm_loss(logits, ys)
    return torch.stack([lm_loss(logits[:, s], ys[:, s])
                        for s in range(ys.shape[1])]).mean()


def _replica_forward(model: PipelineStageLM, pipe, seq, ep, rep: dict,
                     layers: list, xs: torch.Tensor, ys: torch.Tensor,
                     n_micro: int, anchor=None, moe_loss_coef: float = 0.01):
    """One replica's pipelined forward over the stages held:
    ``(objective, cross-entropy, dropped, tail)``, the three scalars of
    the stages held (the last stage's cross-entropy, zero elsewhere; a
    MoE model's load-balancing and dropped sums of the stages' valid
    ticks over ``n_micro · L``, else None) and the schedule's tail."""
    cfg = model.cfg
    xm = _micro(xs, n_micro, ep, seq)
    ym = _micro(ys, n_micro, ep, seq)
    device = xm.device
    pos = _positions(model, seq, xm.shape[-1], device)
    aux = [] if cfg.moe_experts else None
    # stage 0 embeds every microbatch at once
    emb = model.embed_tokens(rep, xm) if 0 in pipe.stages else None

    def inject(m):
        return emb[m]

    def body(j, h, m):
        return model.blocks(layers[j], h, pos, seq, ep, aux)

    def carry():
        return torch.zeros(*xm.shape[1:], cfg.d_model,
                           dtype=model.carry_dtype, device=device)

    hidden, tail = run_schedule(pipe, n_micro, inject, body, carry, anchor)
    if hidden:
        ce = _stage_loss(model, seq, rep, hidden, ym)
    else:
        ce = torch.zeros((), dtype=torch.float32, device=device)
    if aux is None:
        return ce, ce, None, tail
    denom = n_micro * cfg.n_layers
    zero = torch.zeros((), dtype=torch.float32, device=device)
    lb = sum((l.mean() for l, _ in aux), zero) / denom
    dropped = sum((d.mean() for _, d in aux), zero) / denom
    return ce + moe_loss_coef * lb, ce, dropped.detach(), tail


def _split(z_r: dict, held: int, n_local: int, grad: bool = True):
    """A replica's leaves as the step takes them: the replicated ones,
    and each held stage's layers (``[j][i]``, one dict a layer, keyed by
    the block's names); with ``grad``, autograd leaves."""
    def leaf(p):
        return p.detach().requires_grad_(True) if grad else p

    rep = {n: leaf(p) for n, p in z_r.items() if not is_stage(n)}
    layers = [[{n[len(STACK):]: leaf(p[j, i]) for n, p in z_r.items()
                if is_stage(n)} for i in range(n_local)]
              for j in range(held)]
    return rep, layers


def _join(z_r: dict, rep_g: dict, layer_g: list) -> dict:
    """Gradients in the state's layout from :func:`_split`'s leaves'."""
    out = {}
    for n in z_r:
        if is_stage(n):
            leaf = n[len(STACK):]
            out[n] = torch.stack([torch.stack([lay[leaf] for lay in st])
                                  for st in layer_g])
        else:
            out[n] = rep_g[n]
    return out


def pp_global_norm(grads: dict, pipe, ep=None) -> torch.Tensor:
    """``[R]``: each held stage's L2 norm of the leaves it holds (every
    replicated leaf and its own stack; under ``ep`` each ep shard's, its
    expert slices alone), meaned over the stages (``pipe.mean_stages``:
    across processes an all-reduce on the pipe group), then over the ep
    shards (the reference's ``pmean(global_norm(grads), pipe)`` then over
    seq and ep, ``train/pp.py:350-353`` there)."""
    held_ep = 1 if ep is None else len(ep.shards)
    held_pp = len(pipe.stages)
    rows = next(iter(grads.values())).shape[0]

    def sq(n: str, g: torch.Tensor, i: int) -> torch.Tensor:
        if ep is not None and is_expert(n):
            # [L/pp, E, ...]: the E dim
            g = g.chunk(held_ep, 1)[i]
        return g.float().square().sum()

    norms = torch.stack([torch.stack([torch.stack([torch.sqrt(sum(
        sq(n, g[r, j] if is_stage(n) else g[r], i)
        for n, g in grads.items())) for i in range(held_ep)])
        for r in range(rows)]) for j in range(held_pp)])
    x = pipe.mean_stages(norms)              # [R, held_ep]
    return x[:, 0] if ep is None else ep.mean_shards(x.T)


def _check(model: PipelineStageLM, pipe, seq, ep) -> None:
    check_pp_config(model.cfg)
    _check_seq(model, seq)
    check_ep_axis(model.cfg, ep)
    if model.cfg.n_layers != model.n_local_layers * pipe.size:
        raise ValueError(f"a stage of {model.n_local_layers} layers of "
                         f"n_layers {model.cfg.n_layers} with {pipe!r}")


def build_pp_train_step(model: PipelineStageLM, algorithm: GossipAlgorithm,
                        tx, lr_schedule, itr_per_epoch: int, pipe,
                        n_micro: int, seq=None, ep=None,
                        moe_loss_coef: float = 0.01) -> typing.Callable:
    """Step ``(state, tokens, targets) -> (state, metrics)`` over the
    stages ``pipe`` holds, for the batches of ``train/lm.py::
    build_lm_train_step`` cut into ``n_micro`` microbatches (see the
    module docstring); metrics ``loss``, ``ppl``, ``lr``, ``grad_norm``
    and, for a MoE model, ``moe_dropped``, one a held replica."""
    _check(model, pipe, seq, ep)
    if n_micro < 1:
        raise ValueError(f"--n_micro must be >= 1 (got {n_micro})")
    codec = getattr(algorithm, "wire", None)
    if codec is not None and codec.blocked:
        check_pp_wire_blocks(model, len(pipe.stages),
                             1 if ep is None else ep.size, codec.block,
                             None if ep is None else len(ep.shards))
    algorithm.bind_layout(reference_layout(model))
    moe = model.cfg.moe_experts > 0
    dist = isinstance(pipe, DistPipe) and pipe.size > 1
    held, n_local = len(pipe.stages), model.n_local_layers

    def replica_grads(z_r: dict, toks, tgts):
        rep, layers = _split(z_r, held, n_local)
        anchor = (torch.zeros((), device=toks.device, requires_grad=True)
                  if dist else None)
        loss, ce, dropped, tail = _replica_forward(
            model, pipe, seq, ep, rep, layers, toks, tgts, n_micro, anchor,
            moe_loss_coef)
        inputs = list(rep.values()) + [p for st in layers for lay in st
                                       for p in lay.values()]
        roots, seeds = [], []
        if loss.requires_grad:
            roots.append(loss)
            seeds.append(torch.ones_like(loss))
        if dist:
            # the end of the hand-off chain: every exchange's backward
            # runs, in every process, in reverse tick order
            roots.append(tail[0])
            seeds.append(torch.zeros_like(tail[0]))
            inputs.append(anchor)
        got = torch.autograd.grad(roots, inputs, seeds, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(inputs, got)]
        it = iter(got)
        rep_g = {n: next(it) for n in rep}
        layer_g = [[{n: next(it) for n in lay} for lay in st]
                   for st in layers]
        scalars = [loss.detach(), ce.detach()] + ([dropped] if moe else [])
        return _join(z_r, rep_g, layer_g), scalars

    def train_step(state: TrainState, tokens, targets):
        params, gstate = algorithm.pre_step(state.params, state.gossip)
        z = algorithm.eval_params(params, gstate)
        per_rank = [replica_grads({n: p[r] for n, p in z.items()},
                                  tokens[r], targets[r])
                    for r in range(tokens.shape[0])]
        grads = {n: torch.stack([g[n] for g, _ in per_rank]) for n in z}
        scalars = [torch.stack(x) for x in zip(*(s for _, s in per_rank))]
        k = len(scalars)
        # the replicated leaves' gradients and the loss scalars summed
        # over the stages (the reference's psum over pipe)
        rep = [n for n in grads if not is_stage(n)]
        out = pipe.sum_stages([*scalars, *(grads[n] for n in rep)])
        scalars = out[:k]
        grads.update(zip(rep, out[k:]))
        if seq is not None:
            out = seq.pmean([*scalars, *grads.values()])
            scalars, grads = out[:k], dict(zip(grads, out[k:]))
        if ep is not None:
            grads = ep.reduce_grads(grads)
            scalars = ep.pmean(scalars)
        loss = scalars[0]
        ce = scalars[1]
        grads = algorithm.reduce_grads(grads)

        step = state.step
        lr = lr_schedule(step // itr_per_epoch, step % itr_per_epoch,
                         itr_per_epoch)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        params = {n: p - float(lr) * updates[n] for n, p in params.items()}
        params, gstate = algorithm.post_step(params, gstate)

        metrics = {"loss": loss, "ppl": torch.exp(ce), "lr": lr,
                   "grad_norm": pp_global_norm(grads, pipe, ep)}
        if moe:
            metrics["moe_dropped"] = scalars[2]
        return TrainState(step=step + 1, params=params,
                          opt_state=opt_state, gossip=gstate), metrics

    return train_step


def build_pp_eval_step(model: PipelineStageLM, algorithm: GossipAlgorithm,
                       pipe, n_micro: int, seq=None,
                       ep=None) -> typing.Callable:
    """Eval ``(state, tokens, targets) -> {"loss", "ppl"}``, one value a
    held replica: the de-biased parameters (``algorithm.val_params``)
    through the schedule under ``torch.no_grad``, the bare
    cross-entropy of the last stage summed over the stages, then meaned
    over seq and ep (the reference's ``build_pp_eval_step``)."""
    _check(model, pipe, seq, ep)
    held, n_local = len(pipe.stages), model.n_local_layers

    def eval_step(state: TrainState, tokens, targets) -> dict:
        with torch.no_grad():
            z = algorithm.val_params(state.params, state.gossip)
            ces = []
            for r in range(tokens.shape[0]):
                rep, layers = _split({n: p[r] for n, p in z.items()},
                                     held, n_local, grad=False)
                ces.append(_replica_forward(
                    model, pipe, seq, ep, rep, layers, tokens[r],
                    targets[r], n_micro)[1])
            loss = pipe.sum_stages([torch.stack(ces)])[0]
            if seq is not None:
                loss = seq.pmean([loss])[0]
            if ep is not None:
                loss = ep.pmean([loss])[0]
        return {"loss": loss, "ppl": torch.exp(loss)}

    return eval_step
