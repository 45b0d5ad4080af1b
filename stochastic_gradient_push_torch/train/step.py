"""The image-classification train and eval steps: model + algorithm +
optimizer + LR schedule.

Port of ``stochastic_gradient_push_tpu/train/step.py`` for the flat
gossip mesh: :func:`build_train_step` (with ``grad_accum`` and
``label_smoothing``), :func:`build_eval_step`, :func:`init_train_state`,
:func:`replica_spread` and :func:`unreplicate`.  The step keeps the
reference's slot order exactly::

    normalize (uint8 -> ImageNet-normalized f32) → pre_step → eval_params
      → per-rank forward/backward with rank-local BatchNorm → reduce_grads
      → LR → numerator update → post_step → metrics (loss, top1, top5,
      lr, grad_norm)

Batches are rank-stacked NHWC, ``images [R, B, H, W, C]`` (float, or
uint8 normalized on the device) and ``labels [R, B]``, as the
reference's loaders yield them; each rank's images are permuted to NCHW
once for the model.  Each rank's forward and backward is
``torch.func.functional_call`` of one meta-device module with that
rank's de-biased parameters and BatchNorm statistics; one rank's
activations live at a time.  The new running statistics come back
through the forward's ``stats_out`` (``models/resnet.py``), advanced
once per microbatch under ``grad_accum`` as the reference's scan does.

``health_axis`` (the transport the signals reduce over, the
reference's gossip axis) adds the consensus health signals
(``resilience/monitor.py::health_signals``) to the metrics after
``post_step``, on the drained view with the EF residual.  The step tells
the algorithm the model's reference layout
(``models/convert.py::reference_layout``), where the int8 wire cuts its
blocks.

Not ported, and refused by name: ``local_axis`` (intra-node averaging).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
from torch.func import functional_call

from ..algorithms.api import GossipAlgorithm
from ..data.imagefolder import IMAGENET_MEAN, IMAGENET_STD
from ..models.convert import init_model_params, reference_layout
from ..models.resnet import RESNETS
from ..models.small import TinyCNN, TinyMLP
from .metrics import accuracy_topk, global_norm, kl_div_loss, one_hot
from .state import TrainState

__all__ = ["normalize_images", "make_model", "MODELS", "build_train_step",
           "health_metrics", "build_eval_step", "init_train_state", "replica_spread",
           "unreplicate"]

MODELS = {**RESNETS, "tiny_cnn": TinyCNN, "tiny_mlp": TinyMLP}


def make_model(name: str, **kwargs) -> torch.nn.Module:
    """The module a step calls functionally (``MODELS[name](**kwargs)``),
    built on the meta device, so it holds no weights of its own."""
    with torch.device("meta"):
        return MODELS[name](**kwargs)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batches to ImageNet-normalized float32 on the device;
    float batches pass through.  The reference's ``(x / 255 - mean) /
    std`` in the form XLA compiles it to: the divisions become
    multiplies by the float32 reciprocals, and the first multiply and
    the subtraction one fused multiply-add, ``fma(x, f32(1/255), -mean)
    * f32(1/std)`` (``torch.addcmul``, one rounding)."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    neg_mean = torch.as_tensor(-IMAGENET_MEAN, device=dev)
    inv_std = torch.as_tensor(np.float32(1) / IMAGENET_STD, device=dev)
    scale = torch.tensor(np.float32(1 / 255), device=dev)
    return torch.addcmul(neg_mean, images.float(), scale) * inv_std


def _refuse(local_axis) -> None:
    if local_axis is not None:
        raise NotImplementedError(
            "local_axis (intra-node gradient and BN averaging) is not "
            "ported to stochastic_gradient_push_torch yet (ROADMAP.md "
            "Queue 1)")


def health_metrics(params, grads, gstate, transport, layout) -> dict:
    """The consensus health signals of a step's outcome (after
    ``post_step``): the drained view, the EF residual, the reference's
    probe."""
    from ..resilience.monitor import health_signals

    return health_signals(params, grads, gstate.ps_weight, transport,
                          ef_residual=gstate.ef_residual,
                          in_flight=gstate.in_flight, layout=layout)


def _rank(tree: dict, r: int) -> dict:
    return {n: t[r] for n, t in tree.items()}


def build_train_step(model, algorithm: GossipAlgorithm, tx, lr_schedule,
                     itr_per_epoch: int, num_classes: int,
                     local_axis=None, label_smoothing: float = 0.0,
                     grad_accum: int = 1, health_axis=None) -> tp.Callable:
    """Step ``(state, images, labels) -> (state, metrics)``.  Metrics are
    per held rank ``[R]`` (``loss``, ``top1``, ``top5``, ``grad_norm``)
    and the step's ``lr``.  ``grad_accum`` splits each rank's batch into
    that many microbatches: gradients, loss and accuracies are summed,
    then divided, and the BatchNorm EMA advances once per microbatch.
    ``health_axis`` (a transport) adds the health signals."""
    _refuse(local_axis)
    if grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    layout = reference_layout(model) if model is not None else None
    algorithm.bind_layout(layout)

    def rank_step(z_r: dict, stats_r: dict, images, labels):
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        z_r = {n: p.detach().requires_grad_(True) for n, p in z_r.items()}
        x_all = images.permute(0, 3, 1, 2).contiguous()
        sums = None
        for x, y in zip(x_all.chunk(grad_accum), labels.chunk(grad_accum)):
            new_stats: dict = {}
            logits = functional_call(model, {**z_r, **stats_r}, (x,),
                                     {"train": True,
                                      "stats_out": new_stats})
            loss = kl_div_loss(logits, one_hot(y, num_classes,
                                               label_smoothing))
            grads = torch.autograd.grad(loss, list(z_r.values()))
            top1, top5 = accuracy_topk(logits.detach(), y)
            stats_r = new_stats
            part = [*grads, loss.detach(), top1, top5]
            sums = part if sums is None else [a + b for a, b in
                                              zip(sums, part)]
        if grad_accum > 1:
            sums = [a / grad_accum for a in sums]
        *grads, loss, top1, top5 = sums
        return dict(zip(z_r, grads)), stats_r, (loss, top1, top5)

    def train_step(state: TrainState, images, labels):
        images = normalize_images(images)
        params, gstate = algorithm.pre_step(state.params, state.gossip)
        z = algorithm.eval_params(params, gstate)

        per_rank = [rank_step(_rank(z, r), _rank(state.batch_stats, r),
                              images[r], labels[r])
                    for r in range(images.shape[0])]
        grads = {n: torch.stack([g[n] for g, _, _ in per_rank]) for n in z}
        batch_stats = {n: torch.stack([s[n] for _, s, _ in per_rank])
                       for n in state.batch_stats}
        loss, top1, top5 = (torch.stack([m[i] for _, _, m in per_rank])
                            for i in range(3))
        grads = algorithm.reduce_grads(grads)

        step = state.step
        lr = lr_schedule(step // itr_per_epoch, step % itr_per_epoch,
                         itr_per_epoch)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        params = {n: p - float(lr) * updates[n] for n, p in params.items()}
        params, gstate = algorithm.post_step(params, gstate)

        metrics = {"loss": loss, "top1": top1, "top5": top5, "lr": lr,
                   "grad_norm": global_norm(grads)}
        if health_axis is not None:
            metrics.update(health_metrics(params, grads, gstate,
                                          health_axis, layout))
        return TrainState(step=step + 1, params=params, opt_state=opt_state,
                          gossip=gstate, batch_stats=batch_stats), metrics

    return train_step


def build_eval_step(model, algorithm: GossipAlgorithm,
                    num_classes: int) -> tp.Callable:
    """Eval step ``(state, images, labels) -> metrics``: the validation
    view of the params (``algorithm.val_params``: the overlap FIFO
    drained, de-biased), running BatchNorm statistics, no gossip; per
    held rank ``loss``, ``top1``, ``top5``."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        images = normalize_images(images)
        z = algorithm.val_params(state.params, state.gossip)
        out = []
        for r in range(images.shape[0]):
            logits = functional_call(
                model, {**_rank(z, r), **_rank(state.batch_stats, r)},
                (images[r].permute(0, 3, 1, 2).contiguous(),),
                {"train": False})
            out.append((kl_div_loss(logits, one_hot(labels[r],
                                                     num_classes)),
                        *accuracy_topk(logits, labels[r])))
        return {k: torch.stack([o[i] for o in out])
                for i, k in enumerate(("loss", "top1", "top5"))}

    return eval_step


def init_train_state(model, algorithm: GossipAlgorithm, tx, world: int,
                     seed: int = 0,
                     device: str | torch.device = "cpu") -> TrainState:
    """Fresh state for ``world`` held ranks: every rank starts from the
    same parameters and BatchNorm statistics, drawn from ``seed`` with
    the reference's init recipe (``models/convert.py::
    init_model_params``), zero momentum, ps-weight 1."""
    params, stats = init_model_params(model, seed)

    def stack(tree):
        return {n: t.to(device)[None].expand(world, *t.shape).clone()
                for n, t in tree.items()}

    params = stack(params)
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      gossip=algorithm.init(params),
                      batch_stats=stack(stats))


def unreplicate(tree, rank: int = 0):
    """One rank's slice of a rank-stacked dict (nested dicts, tuples and
    lists of tensors)."""
    if isinstance(tree, dict):
        return {k: unreplicate(v, rank) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(unreplicate(v, rank) for v in tree)
    return tree[rank]


@torch.no_grad()
def replica_spread(state: TrainState, algorithm: GossipAlgorithm,
                   transport=None) -> dict:
    """Cross-replica disagreement of the de-biased parameters: max and
    mean absolute deviation from the rank mean over every parameter,
    the per-rank-averaged L2 norm of the deviation, and the largest
    parameter magnitude.  The deviations are fp32, on the state's
    device; their mean and norm accumulate in fp64 (an fp32 sum over
    ~10^8 elements drifts by a few tenths of a percent).  With one rank
    per process (``transport`` holds fewer ranks than its world) the
    mean and the sums reduce across processes."""
    z = algorithm.eval_params(state.params, state.gossip)
    flat = torch.cat([p.float().reshape(p.shape[0], -1) for p in z.values()],
                     dim=1)
    if transport is not None and len(transport.ranks) < transport.world_size:
        world = transport.world_size
        dev = (flat - transport.allreduce_sum(flat) / world).abs()

        def total(x):
            return float(transport.allreduce_sum(x.reshape(1))[0])

        def most(x):
            return float(transport.allreduce_max(x.reshape(1))[0])

        return {"max_spread": most(dev.max()),
                "mean_spread": total(dev.sum(dtype=torch.float64))
                / dev.numel() / world,
                "spread_l2": total(dev.square().sum(dtype=torch.float64))
                ** 0.5 / world ** 0.5,
                "param_scale": most(flat.abs().max())}
    world = flat.shape[0]
    dev = (flat - flat.mean(0, keepdim=True)).abs()
    return {"max_spread": float(dev.max()),
            "mean_spread": float(dev.mean(dtype=torch.float64)),
            "spread_l2": float(torch.linalg.vector_norm(
                dev, dtype=torch.float64) / world ** 0.5),
            "param_scale": float(flat.abs().max())}
