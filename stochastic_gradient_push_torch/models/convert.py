"""JAX parameter trees <-> the port's ``TransformerLM`` parameters.

The JAX package keeps a model's parameters as a nested dict (the flax
tree that ``model.init(...)["params"]`` and ``serve/load.py::
load_consensus`` return).  :func:`params_from_jax` turns that tree, with
numpy (or array-like) leaves, into a ``state_dict`` for
``models/transformer.py::TransformerLM``.

**Transposition.**  A flax ``Dense`` kernel is ``[in, out]`` and computes
``x @ kernel``; ``nn.Linear.weight`` is ``[out, in]`` and computes
``x @ weight.T``.  Every ``kernel`` leaf is transposed here, and only
here; embeddings, LayerNorm scales and biases carry over as they are.

:func:`init_params` builds a tree in that same layout with numpy from a
seed (embedding N(0, 0.02), lecun-normal kernels, zero biases, unit
LayerNorm scales: the flax initialisers' distributions, not their
bits), so a full-width model can be made without JAX.

:func:`train_state_from_jax` carries a whole rank-stacked training
state across (params, the SGD momentum buffers, the push-sum weight, the
phase, the step and an overlap run's in-flight FIFO), so the port and
the reference can start from one state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["params_from_jax", "init_params", "config_from_params",
           "flatten_tree", "unflatten_tree", "train_state_from_jax"]

# flax leaf name -> nn.Module parameter name
_LEAF = {"embedding": "weight", "kernel": "weight", "scale": "weight",
         "bias": "bias"}


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> ``{"block_0/attn/q/kernel": array, ...}``."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_tree(flat) -> dict:
    """Inverse of :func:`flatten_tree` (e.g. for an ``np.load``-ed npz)."""
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The flax tree of a ``TransformerLM`` as a ``TransformerLM``
    ``state_dict`` of fp32 CPU tensors (kernels transposed).  Leaves may
    carry leading dims (a rank-stacked training state): the kernels'
    last two dims are the ones transposed."""
    state = {}
    for path, arr in flatten_tree(tree).items():
        *mods, leaf = path.split("/")
        if leaf not in _LEAF:
            raise ValueError(f"unexpected parameter leaf {path!r}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":   # [..., in, out] -> [..., out, in]
            t = t.transpose(-1, -2).contiguous()
        state[".".join([*mods, _LEAF[leaf]])] = t
    return state


def config_from_params(tree, n_heads: int) -> TransformerConfig:
    """The model's shape read off a flax tree (only ``n_heads`` cannot
    be: the reference engine takes it from its ServeConfig too)."""
    vocab, d_model = np.shape(tree["embed"]["embedding"])
    n_layers = sum(1 for k in tree if str(k).startswith("block_"))
    d_ff = np.shape(tree["block_0"]["up"]["kernel"])[1]
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads "
                         f"{n_heads}")
    return TransformerConfig(vocab_size=int(vocab), d_model=int(d_model),
                             n_layers=n_layers, n_heads=int(n_heads),
                             d_ff=int(d_ff))


def _lecun_normal(rng: np.random.Generator, fan_in: int, shape):
    """flax ``lecun_normal``: a standard normal truncated to (-2, 2),
    rescaled to unit variance, times ``fan_in ** -0.5``."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) >= 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) >= 2.0
    # stddev of the standard normal truncated to (-2, 2)
    return x * np.float32(fan_in ** -0.5 / 0.87962566103423978)


def init_params(cfg: TransformerConfig, seed: int) -> dict:
    """A fresh parameter tree in the flax layout, made with numpy."""
    rng = np.random.default_rng(seed)
    e, f = cfg.d_model, cfg.d_ff

    def dense(n_in, n_out, bias):
        p = {"kernel": _lecun_normal(rng, n_in, (n_in, n_out))}
        if bias:
            p["bias"] = np.zeros(n_out, np.float32)
        return p

    def ln():
        return {"scale": np.ones(e, np.float32),
                "bias": np.zeros(e, np.float32)}

    tree = {"embed": {"embedding": rng.standard_normal(
        (cfg.vocab_size, e), dtype=np.float32) * np.float32(0.02)}}
    for i in range(cfg.n_layers):
        tree[f"block_{i}"] = {
            "ln1": ln(),
            "attn": {n: dense(e, e, False) for n in ("q", "k", "v", "o")},
            "ln2": ln(),
            "up": dense(e, f, True),
            "down": dense(f, e, True),
        }
    tree["ln_f"] = ln()
    tree["lm_head"] = dense(e, cfg.vocab_size, False)
    return tree


def train_state_from_jax(state, device: str | torch.device = "cpu"):
    """The reference's rank-stacked LM ``TrainState`` (leaves as numpy
    arrays, e.g. after ``jax.device_get``) as the port's
    :class:`~..train.state.TrainState`: params and the optimizer's trace
    (momentum) buffers through :func:`params_from_jax`, the
    ``GossipState`` ps-weight ``[R]`` as float32, the phase and the step
    as ints (they are equal on every rank), and an overlap run's
    in-flight FIFO (each slot's params through :func:`params_from_jax`,
    its ps-weight ``[R]``)."""
    from ..algorithms.api import GossipState
    from ..train.state import TrainState

    traces = [s.trace for s in state.opt_state if hasattr(s, "trace")]
    if len(traces) != 1:
        raise ValueError("expected one optax trace (momentum) state in "
                         "opt_state (the reference's sgd chain)")

    def to_dev(tree):
        return {n: t.to(device) for n, t in params_from_jax(tree).items()}

    def scalar(x):
        return int(np.asarray(x).reshape(-1)[0])

    def weight(x):
        w = np.asarray(x, np.float32).reshape(-1)
        return torch.from_numpy(w.copy()).to(device)

    in_flight = tuple((to_dev(p), weight(w))
                      for p, w in getattr(state.gossip, "in_flight", None)
                      or ())
    return TrainState(
        step=scalar(state.step), params=to_dev(state.params),
        opt_state=to_dev(traces[0]),
        gossip=GossipState(phase=scalar(state.gossip.phase),
                           ps_weight=weight(state.gossip.ps_weight),
                           in_flight=in_flight))
