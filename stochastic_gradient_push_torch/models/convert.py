"""JAX parameter trees <-> the port's ``TransformerLM`` parameters.

The JAX package keeps a model's parameters as a nested dict (the flax
tree that ``model.init(...)["params"]`` and ``serve/load.py::
load_consensus`` return).  :func:`params_from_jax` turns that tree, with
numpy (or array-like) leaves, into a ``state_dict`` for
``models/transformer.py::TransformerLM``; :func:`params_to_jax` is its
inverse, so a port parameter set (a training state's row, or the
consensus ``serve/load.py::load_consensus`` ingests) feeds the serving
engine, which takes the flax tree.

**Transposition.**  A flax ``Dense`` kernel is ``[in, out]`` and computes
``x @ kernel``; ``nn.Linear.weight`` is ``[out, in]`` and computes
``x @ weight.T``.  Every ``kernel`` leaf is transposed here, and only
here; embeddings, LayerNorm scales and biases carry over as they are,
and so do a MoE block's raw leaves (``moe/router`` ``[D, E]``,
``moe/experts_up`` ``[E, D, F]``, ``moe/experts_down`` ``[E, F, D]``:
``self.param`` arrays, not Dense kernels).

:func:`init_params` builds a tree in that same layout with numpy from a
seed (embedding N(0, 0.02), lecun-normal kernels, zero biases, unit
LayerNorm scales: the flax initialisers' distributions, not their
bits), so a full-width model can be made without JAX.

:func:`train_state_from_jax` carries a whole rank-stacked training
state across (params, the SGD momentum buffers, the push-sum weight, the
phase, the step and an overlap run's in-flight FIFO), so the port and
the reference can start from one state.

**Pipeline stages** (``models/pipeline.py::PipelineStageLM``).  The
reference's pipeline tree is ``embed``, ``ln_f``, ``lm_head`` and
``stack/block/<leaf>``, each stack leaf ``[L, ...]`` gathered over the
stages (its rank-stacked state ``[R, L, ...]``, with ``[R, L, E, ...]``
expert stacks).  The port's stage leaves are ``stack.<leaf>``, the
layer dim cut into ``[pp, L/pp]`` (``params_from_jax(tree, pp=)``;
with ``stages`` and ``ep_shards`` one process's ``(stage, e)`` block,
``[1, L/pp, E/ep, ...]`` of an expert stack); :func:`join_stages` joins
the stage processes' parts, :func:`params_to_jax` the stages (and with
``ep`` the ep shards' parts) back into the layer dim, and
:func:`assemble` turns the pipeline tree into the ``TransformerLM``
tree (``block_{i}`` the stack's layer ``i``: the reference tests'
``_assemble_reference_params``; :func:`pipeline_tree` is its inverse),
so a pipeline state and a ``TransformerLM`` one compare leaf for leaf.

**Vision models** (``models/resnet.py``, ``models/small.py``).
:func:`vision_params_from_jax` maps a flax ``{"params", "batch_stats"}``
pair onto the port's parameter and buffer names: the flax auto-names
(``conv_init``, ``bn_init``, ``Bottleneck_{k}/Conv_{i}``,
``.../BatchNorm_{i}``, ``conv_proj``, ``norm_proj``, ``fc``; ``Conv_{i}``,
``BatchNorm_{i}``, ``Dense_{i}`` in the small models) become ``conv1``,
``bn1``, ``layer{s}.{j}.conv{i+1}``, ``.downsample.{0,1}``, ``fc``
(under ``norm_variant`` ``bn16``/``folded`` a block's ``ProbeBatchNorm_{i}``
becomes ``bn{i+1}``; the s2d stem's ``[4, 4, 4C, F]`` kernel becomes
``conv1``'s ``[F, 4C, 4, 4]``).  HWIO
convolution kernels become OIHW, Dense ``[in, out]`` becomes ``[out,
in]``, BatchNorm ``scale``/``bias`` its weight/bias and ``batch_stats``
``mean``/``var`` its ``running_mean``/``running_var``.  Every flax leaf
must map and every port tensor must be fed.  :func:`init_model_params`
draws a vision model's parameters from a seed with numpy, following the
initializer each module carries (the reference's recipe), so a
full-width model needs no JAX.

**Reference layout.**  :func:`reference_layout` records, for each of a
model's port parameters, where the reference keeps it: the reference's
leaf order (JAX flattens a dict in sorted-key order) and the dims
permutation that turns the port's tensor into the reference's layout
(HWIO and ``[in, out]`` kernels).  The int8 wire blocks each leaf in that
layout and the health probe reads it (``parallel/wire.py::
ReferenceLayout``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["params_from_jax", "params_to_jax", "init_params", "config_from_params",
           "flatten_tree", "unflatten_tree", "train_state_from_jax",
           "vision_params_from_jax", "init_model_params",
           "reference_layout", "assemble", "pipeline_tree", "join_stages"]

# flax leaf name -> nn.Module parameter name
_LEAF = {"embedding": "weight", "kernel": "weight", "scale": "weight",
         "bias": "bias"}
# a MoE block's raw leaves: the same name on both sides, never transposed
_RAW = ("router", "experts_up", "experts_down")
# each flax leaf's dims in one layer of one replica: a stack leaf's layer
# dim sits just before them, the rank dims before that
_LEAF_NDIM = {"embedding": 2, "kernel": 2, "scale": 1, "bias": 1,
              "router": 2, "experts_up": 3, "experts_down": 3}


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


def pipeline_tree(tree) -> dict:
    """The pipeline tree of a ``TransformerLM`` tree (flax layouts,
    numpy leaves, optionally rank-stacked): every ``block_{i}`` stacked
    on a new layer dim after the rank dims, under ``stack/block``; the
    inverse of :func:`assemble`."""
    blocks = sorted((k for k in tree if str(k).startswith("block_")),
                    key=lambda k: int(str(k)[6:]))
    flat = [flatten_tree(tree[k]) for k in blocks]
    stacked = {}
    for path in flat[0]:
        leaf = path.rsplit("/", 1)[-1]
        arrs = [np.asarray(f[path]) for f in flat]
        d = arrs[0].ndim - _LEAF_NDIM[leaf]
        stacked[path] = np.stack(arrs, axis=d)
    out = {k: v for k, v in tree.items() if not str(k).startswith("block_")}
    out["stack"] = {"block": unflatten_tree(stacked)}
    return out


def assemble(tree) -> dict:
    """The ``TransformerLM`` tree of a pipeline tree (flax layouts, numpy
    leaves, optionally rank-stacked): ``block_{i}`` is layer ``i`` of
    every ``stack/block`` leaf (the reference tests'
    ``_assemble_reference_params``)."""
    per = {}
    for path, arr in flatten_tree(tree["stack"]["block"]).items():
        d = arr.ndim - _LEAF_NDIM[path.rsplit("/", 1)[-1]] - 1
        per[path] = (arr, d)
    out = {k: v for k, v in tree.items() if k != "stack"}
    for i in range(arr.shape[d]):
        out[f"block_{i}"] = unflatten_tree(
            {path: np.take(arr, i, axis=d) for path, (arr, d) in
             per.items()})
    return out


def params_from_jax(tree, tp: int = 1, shards=None, ep: int = 1,
                    ep_shards=None, pp: int = 1,
                    stages=None) -> dict[str, torch.Tensor]:
    """The flax tree of a ``TransformerLM`` as a ``TransformerLM``
    ``state_dict`` of fp32 CPU tensors (kernels transposed).  Leaves may
    carry leading dims (a rank-stacked training state): the kernels'
    last two dims are the ones transposed.  With ``ep`` > 1 and
    ``ep_shards`` the tree is rank-stacked and its expert stacks keep
    those ep shards' experts (``parallel/ep.py::shard_experts``; without
    ``ep_shards`` every expert, as a stack holds them); then with ``tp``
    > 1 its leaves are placed for the tensor-parallel ``shards`` (default
    all; ``parallel/tp.py::shard_params``): an expert stack as its ``(e,
    t)`` slices.  A pipeline tree (``stack/block/...``) becomes
    ``PipelineStageLM`` leaves ``stack.<leaf>``, each layer dim cut into
    ``[pp, L/pp]``: every stage, or those of ``stages`` (stage indices,
    in order), ``[held, L/pp]``; with ``ep_shards`` an expert stack then
    keeps those shards' experts, ``[held, L/pp, held·E/ep, ...]`` (one
    process's ``(stage, e)`` block)."""
    if tp > 1 or (ep > 1 and ep_shards is not None):
        from ..parallel.ep import shard_experts
        from ..parallel.tp import shard_params

        state = params_from_jax(tree, pp=pp, stages=stages)
        if ep > 1 and ep_shards is not None:
            state = shard_experts(state, ep, ep_shards)
        return shard_params(state, tp, shards) if tp > 1 else state
    state = {}
    for path, arr in flatten_tree(tree).items():
        *mods, leaf = path.split("/")
        if leaf not in _LEAF and leaf not in _RAW:
            raise ValueError(f"unexpected parameter leaf {path!r}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":   # [..., in, out] -> [..., out, in]
            t = t.transpose(-1, -2).contiguous()
        if mods[:2] == ["stack", "block"]:
            mods = mods[1:]
            mods[0] = "stack"
            d = t.dim() - _LEAF_NDIM[leaf] - 1     # the layer dim
            if t.shape[d] % pp:
                raise ValueError(f"{path}: {t.shape[d]} layers not "
                                 f"divisible by pp {pp}")
            t = t.reshape(*t.shape[:d], pp, -1, *t.shape[d + 1:])
            if stages is not None:
                t = t[(slice(None),) * d + (list(stages),)].contiguous()
        state[".".join([*mods, _LEAF.get(leaf, leaf)])] = t
    return state


def join_stages(parts: list) -> dict:
    """One state of every stage from each stage process's (in stage
    order, each holding ``[..., 1, L/pp, ...]`` of a stage leaf, as
    :func:`params_from_jax` with ``stages`` places it): the stage leaves
    joined on their held-stage dim, the replicated leaves stage 0's."""
    out = {}
    for name, t in parts[0].items():
        if name.startswith("stack."):
            *mods, leaf = name.split(".")
            ndim = (_LEAF_NDIM[leaf] if leaf in _RAW else 1
                    if leaf == "bias" or mods[-1] in ("ln1", "ln2") else 2)
            d = np.ndim(t) - ndim - 2
            t = torch.cat([torch.as_tensor(p[name]) for p in parts], d)
        out[name] = t
    return out


def _gather_tp(state, tp: int) -> dict:
    """A rank-stacked state holding every tp shard as its logical leaves
    (``parallel/tp.py::gather_params``; as it is at ``tp`` 1)."""
    from ..parallel.tp import gather_params

    state = {n: torch.as_tensor(t) for n, t in state.items()}
    return gather_params(state, tp) if tp > 1 else state


def params_to_jax(state, tp: int = 1, ep: int = 1,
                  pp: int | None = None) -> dict:
    """Inverse of :func:`params_from_jax`: a ``TransformerLM``
    ``state_dict`` (tensors or arrays, optionally with leading rank
    dims) as the flax tree of numpy arrays, kernels transposed back.
    Values keep their dtype and bits.  With ``tp`` > 1 a rank-stacked
    state holding every tensor-parallel shard is gathered into the
    logical leaves first; with ``ep`` > 1 ``state`` is the list of every
    ep shard's state (each holding its experts, in shard order), whose
    expert stacks are joined (``parallel/ep.py::gather_experts``).  A
    ``PipelineStageLM`` state holding every stage (its ``stack.<leaf>``
    leaves ``[..., pp, L/pp, ...]``, ``pp`` checked when given) becomes
    the pipeline tree, the stages joined into the layer dim ``[..., L,
    ...]``."""
    if ep > 1:
        from ..parallel.ep import gather_experts

        state = gather_experts([_gather_tp(part, tp) for part in state])
    elif tp > 1:
        state = _gather_tp(state, tp)
    flat = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        if leaf not in ("weight", "bias", *_RAW) or not mods:
            raise ValueError(f"unexpected parameter {name!r}")
        arr = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t))
        if leaf == "weight":
            # the module decides: Embedding, LayerNorm or Dense
            if mods[-1] == "embed":
                leaf = "embedding"
            elif mods[-1] in ("ln1", "ln2", "ln_f"):
                leaf = "scale"
            else:   # [..., out, in] -> [..., in, out]
                leaf, arr = "kernel", np.swapaxes(arr, -1, -2)
        if mods[0] == "stack":
            # [..., pp, L/pp, ...] -> [..., L, ...]
            d = arr.ndim - _LEAF_NDIM[leaf] - 2
            if pp is not None and arr.shape[d] != pp:
                raise ValueError(f"{name}: {arr.shape[d]} stages held, not "
                                 f"pp {pp}")
            arr = arr.reshape(*arr.shape[:d], -1, *arr.shape[d + 2:])
            mods = ["stack", "block", *mods[1:]]
        flat["/".join([*mods, leaf])] = np.ascontiguousarray(arr)
    return unflatten_tree(flat)


def config_from_params(tree, n_heads: int) -> TransformerConfig:
    """The model's shape read off a flax tree (only ``n_heads`` cannot
    be: the reference engine takes it from its ServeConfig too)."""
    vocab, d_model = np.shape(tree["embed"]["embedding"])
    n_layers = sum(1 for k in tree if str(k).startswith("block_"))
    moe = [i for i in range(n_layers) if "moe" in tree[f"block_{i}"]]
    if moe:
        # block i is MoE iff i % every == every - 1: the first is every - 1
        first = tree[f"block_{moe[0]}"]["moe"]
        moe_kw = {"moe_experts": int(np.shape(first["router"])[1]),
                  "moe_every": moe[0] + 1}
        d_ff = np.shape(first["experts_up"])[-1]
    else:
        moe_kw = {}
        d_ff = np.shape(tree["block_0"]["up"]["kernel"])[1]
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads "
                         f"{n_heads}")
    return TransformerConfig(vocab_size=int(vocab), d_model=int(d_model),
                             n_layers=n_layers, n_heads=int(n_heads),
                             d_ff=int(d_ff), **moe_kw)


def _lecun_normal(rng: np.random.Generator, fan_in: int, shape):
    """flax ``lecun_normal``: a standard normal truncated to (-2, 2),
    rescaled to unit variance, times ``fan_in ** -0.5``."""
    x = rng.standard_normal(shape, dtype=np.float32)
    # redraw the rejected entries, in flat order, until none is left: only
    # a redrawn entry can be rejected again, so each round scans those
    flat = x.reshape(-1)
    bad = np.flatnonzero(np.abs(flat) >= 2.0)
    while bad.size:
        flat[bad] = rng.standard_normal(bad.size, dtype=np.float32)
        bad = bad[np.abs(flat[bad]) >= 2.0]
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

    def moe():
        # flax's lecun_normal on [E, in, out] counts the expert dim into
        # the fan-in (a receptive field of E): E·in
        n = cfg.moe_experts
        return {"router": rng.standard_normal((e, n), dtype=np.float32)
                * np.float32(0.02),
                "experts_up": _lecun_normal(rng, n * e, (n, e, f)),
                "experts_down": _lecun_normal(rng, n * f, (n, f, e))}

    tree = {"embed": {"embedding": rng.standard_normal(
        (cfg.vocab_size, e), dtype=np.float32) * np.float32(0.02)}}
    for i in range(cfg.n_layers):
        tree[f"block_{i}"] = {
            "ln1": ln(),
            "attn": {n: dense(e, e, False) for n in ("q", "k", "v", "o")},
            "ln2": ln(),
        }
        if cfg.use_moe(i):
            tree[f"block_{i}"]["moe"] = moe()
        else:
            tree[f"block_{i}"].update(up=dense(e, f, True),
                                      down=dense(f, e, True))
    tree["ln_f"] = ln()
    tree["lm_head"] = dense(e, cfg.vocab_size, False)
    return tree


def _module_map(model) -> dict[str, str]:
    """Port module name -> flax module path for a vision model."""
    from .resnet import ResNet
    from .small import TinyCNN, TinyMLP

    if isinstance(model, TinyMLP):
        return {"fc1": "Dense_0", "fc2": "Dense_1"}
    if isinstance(model, TinyCNN):
        out = {"fc": "Dense_0"}
        for i in range(3):
            out[f"conv{i}"], out[f"bn{i}"] = f"Conv_{i}", f"BatchNorm_{i}"
        return out
    if not isinstance(model, ResNet):
        raise TypeError(f"no flax map for {type(model).__name__}")
    out = {"conv1": "conv_init", "bn1": "bn_init", "fc": "fc"}
    # flax's auto names carry the norm's class: the reference's
    # ProbeBatchNorm under norm_variant bn16 / folded (the given names,
    # bn_init and norm_proj, stay)
    norm = "BatchNorm" if model.norm_variant == "bn" else "ProbeBatchNorm"
    k = 0
    for s in range(model.stages):
        for j, block in enumerate(getattr(model, f"layer{s + 1}")):
            flax = f"{type(block).__name__}_{k}"
            port = f"layer{s + 1}.{j}"
            n_conv = 3 if hasattr(block, "conv3") else 2
            for i in range(n_conv):
                out[f"{port}.conv{i + 1}"] = f"{flax}/Conv_{i}"
                out[f"{port}.bn{i + 1}"] = f"{flax}/{norm}_{i}"
            if block.downsample is not None:
                out[f"{port}.downsample.0"] = f"{flax}/conv_proj"
                out[f"{port}.downsample.1"] = f"{flax}/norm_proj"
            k += 1
    return out


# flax leaf -> port leaf, per collection
_VISION_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                ("params", "bias"): "bias",
                ("batch_stats", "mean"): "running_mean",
                ("batch_stats", "var"): "running_var"}


def vision_params_from_jax(model, variables) -> tuple[dict, dict]:
    """A vision model's flax ``{"params", "batch_stats"}`` (numpy or
    array-like leaves, optionally with leading rank dims) as the port's
    ``(params, batch_stats)`` dicts of fp32 CPU tensors.  Raises on a
    flax leaf that maps to nothing and on a port tensor left unfed (of a
    collection ``variables`` holds: a momentum tree comes as
    ``{"params": tree}`` alone)."""
    to_flax = _module_map(model)
    to_port = {v: k for k, v in to_flax.items()}
    want_p = dict(model.named_parameters())
    want_b = dict(model.named_buffers())
    params, stats = {}, {}
    for coll, out in (("params", params), ("batch_stats", stats)):
        for path, arr in flatten_tree(variables.get(coll, {})).items():
            mod, _, leaf = path.rpartition("/")
            if mod not in to_port or (coll, leaf) not in _VISION_LEAF:
                raise ValueError(f"unmapped flax leaf {coll}/{path}")
            name = f"{to_port[mod]}.{_VISION_LEAF[coll, leaf]}"
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if leaf == "kernel" and name in want_p:
                if want_p[name].dim() == 4:
                    # [..., kh, kw, in, out] -> [..., out, in, kh, kw]
                    t = t.movedim((-1, -2), (-4, -3))
                else:   # [..., in, out] -> [..., out, in]
                    t = t.transpose(-1, -2)
                t = t.contiguous()
            out[name] = t
    for coll, got, want in (("params", params, want_p),
                            ("batch_stats", stats, want_b)):
        if coll not in variables:
            continue
        if set(got) != set(want):
            raise ValueError(
                f"flax {coll} do not cover the port's tensors: missing "
                f"{sorted(set(want) - set(got))}, extra "
                f"{sorted(set(got) - set(want))}")
        for name, t in got.items():
            if tuple(t.shape[t.dim() - want[name].dim():]) != tuple(
                    want[name].shape):
                raise ValueError(f"{name}: flax shape {tuple(t.shape)}, "
                                 f"port {tuple(want[name].shape)}")
    return params, stats


def init_model_params(model, seed: int) -> tuple[dict, dict]:
    """A vision model's fresh ``(params, batch_stats)`` (fp32 CPU
    tensors, the port's names), drawn with numpy from ``seed`` with the
    initializer each module carries: ``fan_out_normal`` (an untruncated
    normal of variance ``2 / (out * kh * kw)``), ``lecun_normal``,
    ``("normal", std)``; zero biases; BatchNorm scale ``scale_init`` and
    running statistics 0 and 1.  The distributions of the flax
    initializers, not their bits."""
    from .resnet import BatchNorm, Conv2d, Linear, s2d_stem_kernel

    rng = np.random.default_rng(seed)
    params = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, Conv2d):
            cout, cin, kh, kw = mod.weight.shape
            shape = (cout, cin, kh, kw)
            if mod.kernel_init == "s2d_fan_out_normal":
                # drawn as the 7x7 stem's kernel, then transformed
                k7 = rng.standard_normal((cout, cin // 4, 7, 7),
                                         dtype=np.float32) * np.float32(
                    np.sqrt(2.0 / (cout * 49)))
                w = s2d_stem_kernel(torch.from_numpy(k7)).numpy()
            elif mod.kernel_init == "fan_out_normal":
                w = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                    np.sqrt(2.0 / (cout * kh * kw)))
            else:
                w = _lecun_normal(rng, cin * kh * kw, shape)
            params[prefix + "weight"] = w
        elif isinstance(mod, Linear):
            cout, cin = mod.weight.shape
            if mod.kernel_init == "lecun_normal":
                w = _lecun_normal(rng, cin, (cout, cin))
            else:
                w = rng.standard_normal((cout, cin), dtype=np.float32) \
                    * np.float32(mod.kernel_init[1])
            params[prefix + "weight"] = w
            params[prefix + "bias"] = np.zeros(cout, np.float32)
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            params[prefix + "weight"] = np.full(c, mod.scale_init,
                                                np.float32)
            params[prefix + "bias"] = np.zeros(c, np.float32)
    missing = set(dict(model.named_parameters())) - set(params)
    if missing:
        raise ValueError(f"no initializer for {sorted(missing)}")
    stats = {n: (torch.zeros if n.endswith("running_mean") else torch.ones)(
        b.shape) for n, b in model.named_buffers()}
    return {n: torch.from_numpy(a) for n, a in params.items()}, stats


def train_state_from_jax(state, device: str | torch.device = "cpu",
                         model=None, pp: int = 1, stages=None, ep: int = 1,
                         ep_shards=None):
    """The reference's rank-stacked ``TrainState`` (leaves as numpy
    arrays, e.g. after ``jax.device_get``) as the port's
    :class:`~..train.state.TrainState`: params and the optimizer's trace
    (momentum) buffers, the ``GossipState`` ps-weight ``[R]`` as float32,
    the phase and the step as ints (they are equal on every rank), and
    an overlap run's in-flight FIFO (each slot's params mapped, its
    ps-weight ``[R]``).  Without ``model`` the tree is the LM's
    (:func:`params_from_jax`, no BatchNorm statistics); with a vision
    ``model`` it goes through :func:`vision_params_from_jax` and the
    ``batch_stats`` come along.  A pipeline state (the reference's
    ``init_pp_state``: a ``stack`` in its tree) becomes
    ``PipelineStageLM`` leaves of ``pp`` stages (:func:`params_from_jax`),
    with ``stages`` and ``ep_shards`` those of one process's ``(stage,
    e)`` block."""
    from ..algorithms.api import GossipState
    from ..train.state import TrainState

    traces = [s.trace for s in state.opt_state if hasattr(s, "trace")]
    if len(traces) != 1:
        raise ValueError("expected one optax trace (momentum) state in "
                         "opt_state (the reference's sgd chain)")

    def to_dev(tree):
        if model is None:
            out = params_from_jax(tree, ep=ep, ep_shards=ep_shards, pp=pp,
                                  stages=stages)
        else:
            out = vision_params_from_jax(model, {"params": tree})[0]
        return {n: t.to(device) for n, t in out.items()}

    def scalar(x):
        return int(np.asarray(x).reshape(-1)[0])

    def weight(x):
        w = np.asarray(x, np.float32).reshape(-1)
        return torch.from_numpy(w.copy()).to(device)

    params, stats = to_dev(state.params), {}
    if model is not None:
        stats = {n: t.to(device) for n, t in vision_params_from_jax(
            model, {"batch_stats": state.batch_stats})[1].items()}
    in_flight = tuple((to_dev(p), weight(w))
                      for p, w in getattr(state.gossip, "in_flight", None)
                      or ())
    return TrainState(
        step=scalar(state.step), params=params,
        opt_state=to_dev(traces[0]), batch_stats=stats,
        gossip=GossipState(phase=scalar(state.gossip.phase),
                           ps_weight=weight(state.gossip.ps_weight),
                           in_flight=in_flight))


# per-rank dims permutation, port layout -> the reference's
_TO_FLAX = {4: (2, 3, 1, 0),   # OIHW -> HWIO
            2: (1, 0)}         # [out, in] -> [in, out]


def reference_layout(model):
    """A model's :class:`~..parallel.wire.ReferenceLayout`: its port
    parameter names in the reference's flatten order, and the dims
    permutation of each kernel the port transposes (conv OIHW -> HWIO,
    Dense ``[out, in]`` -> ``[in, out]``; a tensor-parallel Dense kernel
    ``[shards, out, in]`` -> ``[shards, in, out]``, each held shard in the
    reference's order, ``parallel/tp.py``; an expert stack's raw ``[tp,
    E, ...]`` shards need none: a ``(e, t)`` shard whose F slice keeps
    the reference's blocks, ``parallel/tp.py::check_wire_blocks``, is
    blocked as the reference blocks its ep slice).  ``model`` is a
    ``TransformerLM`` or a vision model of ``models/resnet.py`` /
    ``models/small.py`` (a meta-device module will do), or a
    ``PipelineStageLM``: the pipeline tree's order (``embed``,
    ``lm_head``, ``ln_f``, ``stack/block/...``) and, for a stack's Dense
    kernel, held as ``[stages, L/pp, out, in]`` a rank, the ``(0, 2, 1)``
    permutation of each stage's ``[L/pp, out, in]`` (``(0, 1, 3, 2)``
    with the stage dim)."""
    from ..parallel.wire import ReferenceLayout
    from .pipeline import PipelineStageLM
    from .transformer import TransformerLM

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    pipeline = isinstance(model, PipelineStageLM)
    if pipeline or isinstance(model, TransformerLM):
        to_flax = None
    else:
        to_flax = _module_map(model)
    paths, perms = {}, {}
    for name, shape in shapes.items():
        mod, _, leaf = name.rpartition(".")
        last = mod.rpartition(".")[2]
        if to_flax is None:
            flax_mod = mod.split(".")
            if flax_mod[0] == "stack":
                flax_mod = ["stack", "block", *flax_mod[1:]]
            if last == "embed":
                kind = "embedding"
            elif leaf in _RAW:
                kind = leaf
            elif last.startswith("ln"):
                kind = "scale" if leaf == "weight" else "bias"
            else:
                kind = "kernel" if leaf == "weight" else "bias"
        else:
            flax_mod = to_flax[mod].split("/")
            if leaf == "bias":
                kind = "bias"
            else:
                kind = "kernel" if len(shape) in _TO_FLAX else "scale"
        paths[name] = tuple(flax_mod) + (kind,)
        if kind == "kernel" and pipeline and flax_mod[0] == "stack":
            # a stage's Dense kernel [L/pp, out, in], held [stages, L/pp,
            # out, in] a rank: each stage in the reference's [L/pp, in,
            # out] order
            perms[name] = (0, 1, 3, 2)
        elif kind == "kernel":
            # a tp-split Dense kernel [shards, out, in] is blocked shard by
            # shard, each in the reference's [in, out] order
            perms[name] = ((0, 2, 1) if to_flax is None and len(shape) == 3
                           else _TO_FLAX[len(shape)])
    return ReferenceLayout(order=tuple(sorted(paths, key=paths.get)),
                           perms=perms)
