"""Dry run of the ResNet SGP training step at small size.

The port's counterpart of the first cell of ``__graft_entry__.py::
dryrun_multichip`` (the reference's multi-chip dry run): one full SGP
train step (forward, backward, torch-semantics nesterov SGD under the
warmup LR schedule, one push-sum round over the n-peer exponential
graph) of ResNet-18 at batch 2, 32 px, 10 classes, with all ``n`` ranks
stacked in this process (``parallel/collectives.py::StackedTransport``).
At world 1 the round returns its input (no transport), and the printed
line says so.  Runs on CUDA unless ``--device cpu``::

    python -m stochastic_gradient_push_torch.run.dryrun --world_size 4 \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["dryrun_multichip", "main"]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One SGP step of the dry-run configuration at world ``n_devices``;
    raises if the loss is not finite or the push-sum weight drifted.
    Returns ``{"loss", "ps_weight", "step"}``."""
    import torch

    from ..algorithms import sgp
    from ..device import resolve_device
    from ..parallel.collectives import StackedTransport
    from ..topology import NPeerDynamicDirectedExponentialGraph, build_schedule
    from ..train.lr import LRSchedule
    from ..train.state import sgd
    from ..train.step import build_train_step, init_train_state, make_model

    device = resolve_device(device)
    batch, img, classes = 2, 32, 10
    model = make_model("resnet18", num_classes=classes)
    schedule = build_schedule(NPeerDynamicDirectedExponentialGraph(
        n_devices, peers_per_itr=1))
    alg = sgp(schedule, StackedTransport(n_devices))
    tx = sgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lr_sched = LRSchedule(ref_lr=0.1, batch_size=batch,
                          world_size=n_devices, warmup=True)
    step = build_train_step(model, alg, tx, lr_sched, itr_per_epoch=100,
                            num_classes=classes)
    state = init_train_state(model, alg, tx, n_devices, seed=0,
                             device=device)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_devices, batch, img, img, 3)).astype(np.float32)
    y = rng.integers(0, classes, size=(n_devices, batch)).astype(np.int32)
    state, metrics = step(state, torch.from_numpy(x).to(device),
                          torch.from_numpy(y).to(device))
    loss = float(metrics["loss"].mean())
    w = state.gossip.ps_weight.cpu().numpy()
    if not np.isfinite(loss):
        raise AssertionError("loss is not finite")
    if not np.allclose(w, 1.0, atol=1e-3):
        raise AssertionError(f"push-sum weight drifted: {w}")
    note = ("; world 1: the gossip round is a no-op (no transport)"
            if n_devices == 1 else "")
    print(f"dryrun_multichip({n_devices}): ok — loss {loss:.4f}, "
          f"ps_weight 1.0, step {state.step} on {device}{note}", flush=True)
    return {"loss": loss, "ps_weight": w.tolist(), "step": state.step}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    return dryrun_multichip(args.world_size, device=args.device)


if __name__ == "__main__":
    main()
