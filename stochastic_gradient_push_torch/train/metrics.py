"""Loss and accuracy metrics of the training harness.

Port of ``stochastic_gradient_push_tpu/train/metrics.py``: the KLDiv
loss of log-softmax against (possibly smoothed) one-hot targets with
batchmean reduction, top-k precision in percent, and the gradient's
global L2 norm per rank.
"""

from __future__ import annotations

import torch

__all__ = ["one_hot", "kl_div_loss", "accuracy_topk", "global_norm"]


def one_hot(labels: torch.Tensor, num_classes: int,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """float32 one-hot targets ``[..., num_classes]``, optionally
    smoothed: ``t * (1 - s) + s / num_classes``."""
    targets = torch.nn.functional.one_hot(labels.long(),
                                          num_classes).to(torch.float32)
    if label_smoothing:
        targets = (targets * (1.0 - label_smoothing)
                   + label_smoothing / num_classes)
    return targets


def kl_div_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean')(log_softmax(logits), target)``:
    KL(target || softmax(logits)) summed over classes, averaged over the
    batch; a zero target contributes 0 (``0 * log 0 = 0``)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    target = target.float()
    pos = target > 0
    entropy = torch.where(pos, target * torch.log(
        torch.where(pos, target, torch.ones_like(target))),
        torch.zeros_like(target))
    return (entropy - target * log_probs).sum() / logits.shape[0]


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  topk=(1, 5)) -> tuple[torch.Tensor, ...]:
    """Precision@k in percent for each k of ``topk``.  Ties rank as the
    reference's reversed stable argsort ranks them (the higher class
    index first)."""
    maxk = max(topk)
    idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :maxk]
    correct = idx == labels.long()[:, None]
    return tuple(100.0 * correct[:, :k].any(-1).float().mean()
                 for k in topk)


def global_norm(grads: dict, tp=None, ep=None) -> torch.Tensor:
    """Per-rank L2 norm over every leaf of rank-stacked gradients
    ``[R, ...]`` (``utils/flatten.py::global_norm`` there): ``[R]``.

    With ``tp`` (``parallel/tp.py``) the norm is over the logical leaves,
    as the reference's over its GSPMD-sharded ones: a split leaf ``[R,
    held, ...]`` counts each shard's sum of squares, folded over the tp
    shards (one all-gather a rank across processes), a replicated leaf
    counts once.  Rank by rank and shard by shard, so a process holding
    one shard computes what the stack does.

    With ``ep`` (``parallel/ep.py``) each ep shard's norm of the
    gradients it holds, the replicated leaves and its own expert slice
    (with ``tp``, that slice at full F: the fold above inside each ep
    shard's norm), meaned over the shards (the reference's ``pmean``
    over ep of its shards' tp-logical norms, ``train/lm.py:403-412``
    there): on a stack the held expert leaves ``[R, (held_tp,) E, ...]``
    are cut into the shards' slices, across processes one all-reduce on
    the ep group."""
    if tp is None and ep is None:
        return torch.sqrt(sum(g.float().square().flatten(1).sum(1)
                              for g in grads.values()))
    from ..parallel.ep import is_expert
    from ..parallel.tp import split_dim

    held_ep = 1 if ep is None else len(ep.shards)
    split = [] if tp is None else [n for n in grads
                                   if split_dim(n) is not None]

    def sq(n: str, g: torch.Tensor, i: int) -> torch.Tensor:
        """The sum of squares of ep shard ``i``'s part of one rank's
        (one tp shard's) leaf ``g``."""
        if ep is not None and is_expert(n):
            g = g.chunk(held_ep, 0)[i]
        return g.float().square().sum()

    norms = []
    for r in range(next(iter(grads.values())).shape[0]):
        row = []
        for i in range(held_ep):
            folded = {}
            if split:
                shard_sq = torch.stack([
                    torch.stack([sq(n, grads[n][r, j], i) for n in split])
                    for j in range(len(tp.shards))])
                folded = dict(zip(split, tp.sum_shards(shard_sq).unbind(0)))
            row.append(torch.sqrt(sum(
                folded[n] if n in folded else sq(n, g[r], i)
                for n, g in grads.items())))
        norms.append(torch.stack(row))
    norms = torch.stack(norms)                   # [R, held_ep]
    return norms[:, 0] if ep is None else ep.mean_shards(norms.T)
