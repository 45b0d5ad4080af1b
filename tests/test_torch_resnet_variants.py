"""The reference's ResNet MFU variants in the port (``models/resnet.py``):
the space-to-depth stem (``stem_s2d``) and the ``ProbeBatchNorm`` norms
(``norm_variant`` ``"bn16"`` and ``"folded"``), against the JAX package
on the CPU, weights carried across by ``models/convert.py``.

* ``space_to_depth`` and ``s2d_stem_kernel`` are bit-equal to the
  reference's, NCHW / OIHW against its NHWC / HWIO; odd image sizes are
  refused by both with the same message.  The s2d stem computes the 7x7/2
  stem's function (fp64, 1e-12).
* Forward logits, the new running statistics and the backward (the
  gradient of a fixed random projection of the logits, every parameter)
  of ``resnet18(num_classes=10, stem_s2d=True)`` and of the ``bn16`` and
  ``folded`` norms (on a one-block-a-stage Bottleneck ResNet of width 8:
  a Bottleneck's three ``ProbeBatchNorm`` and its ``norm_proj``), in
  training and in eval, at fp32 and bf16, against
  the reference's from its own init and the running statistics of one
  ``bn`` training forward: ``test_torch_resnet.py``'s tolerance, 1e-5
  plus twice the reference's own distance from an fp64 run of the same
  weights (the port's modules at ``torch.float64``), the largest over
  the forward's outputs and, apart, over the gradients.  The reference's
  forward is required within a slack of that run (1e-2 at fp32, 5e-2 at
  bf16) so a wrong model cannot widen the bound.  Measured: the forward's
  distances 1e-7 to 3e-6 at fp32, 1.8e-3 to 1.7e-2 at bf16; the
  gradients' 1.4e-6 to 7.7e-5 at fp32, 0.1 to 4.6 at bf16 (bf16
  gradients through 18 layers; ``bn16``'s batch variance taken in bf16).
  The norms use the CIFAR stem (every BatchNorm sees 32 values or more);
  the s2d stem, which exists only with the ImageNet stem, runs at 64 px
  and batch 4 (16 values).  ``bn16`` at fp32 is ``bn``.  The norms'
  cases run in ``test_torch_resnet_norms.py`` (one compiled reference
  program a variant and dtype, shared by its two modes).
* ``folded`` leaves the running statistics bit-unchanged in training.
* Through ``convert.py``: a block's ``ProbeBatchNorm_{i}`` is the port's
  ``bn{i+1}``, the s2d stem's ``[4, 4, 12, F]`` kernel ``conv1``'s ``[F,
  12, 4, 4]``; the numpy init draws the s2d stem as the 7x7 kernel's
  distribution, transformed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stochastic_gradient_push_torch.models import resnet as tres
from stochastic_gradient_push_torch.models.convert import (
    init_model_params, reference_layout, vision_params_from_jax)

TOL = 1e-5
ORACLE_SLACK = {"fp32": 1e-2, "bf16": 5e-2}
VARIANTS = {"s2d": dict(stem_s2d=True),
            "bn16": dict(norm_variant="bn16", small_images=True),
            "folded": dict(norm_variant="folded", small_images=True)}
# the norms on a one-block-a-stage Bottleneck ResNet of width 8 (its
# zero-initialised third norm and its projection's norm_proj among
# them), the stem on resnet18
NET = {"s2d": ([2, 2, 2, 2], "BasicBlock", 64),
       "bn16": ([1, 1, 1, 1], "Bottleneck", 8),
       "folded": ([1, 1, 1, 1], "Bottleneck", 8)}


def _net(lib, variant, **kw):
    """``variant``'s network from ``lib`` (the reference's or the port's
    ``models/resnet.py``)."""
    stages, block, width = NET[variant]
    return lib.ResNet(stage_sizes=stages, block_cls=getattr(lib, block),
                      num_classes=10, num_filters=width,
                      **{**VARIANTS[variant], **kw})
# the s2d stem needs the ImageNet stem: at 64 px and batch 4 its last
# BatchNorm sees 16 values a channel (2 at 32 px and batch 2, where the
# fast variance cancels and the backward parts from fp64 by 0.3)
IMAGES = {"s2d": (4, 64, 64, 3), "bn16": (2, 32, 32, 3),
          "folded": (2, 32, 32, 3)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 224, 224, 3),
                                   (3, 4, 2, 5)])
def test_space_to_depth_is_the_references(shape):
    from stochastic_gradient_push_tpu.models.resnet import space_to_depth

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(space_to_depth(jnp.asarray(x)))
    got = tres.space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, want)


def test_odd_sizes_are_refused_as_the_reference_refuses_them():
    from stochastic_gradient_push_tpu.models.resnet import space_to_depth

    x = np.zeros((1, 33, 32, 3), np.float32)
    with pytest.raises(ValueError, match="divisible by 2, got 33x32") as e:
        space_to_depth(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        tres.space_to_depth(_nchw(x))
    assert str(got.value) == str(e.value)
    model = tres.resnet18(num_classes=10, stem_s2d=True)
    model.load_state_dict({**init_model_params(model, 0)[0],
                           **init_model_params(model, 0)[1]})
    with pytest.raises(ValueError, match="stem_s2d requires"):
        model(_nchw(x), True, {})


@pytest.mark.parametrize("c,f", [(3, 64), (5, 7)])
def test_s2d_stem_kernel_is_the_references(c, f):
    from stochastic_gradient_push_tpu.models.resnet import s2d_stem_kernel

    k = np.random.default_rng(2).standard_normal((7, 7, c, f)).astype(
        np.float32)
    want = np.asarray(s2d_stem_kernel(jnp.asarray(k)))
    got = tres.s2d_stem_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert tuple(got.shape) == (f, 4 * c, 4, 4)
    assert np.array_equal(got.permute(2, 3, 1, 0).numpy(), want)


@pytest.mark.parametrize("size", [32, 30, 224])
def test_the_s2d_stem_is_the_7x7_stem(size):
    """The 4x4/1 convolution over the packed input with block pads (2, 1)
    equals the 7x7/2 convolution with pads (3, 3)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 3, size, size)))
    k7 = torch.from_numpy(r.standard_normal((8, 3, 7, 7)))
    want = F.conv2d(x, k7, stride=2, padding=3)
    conv = tres.Conv2d(12, 8, 4, 1, padding=(2, 1)).double()
    with torch.no_grad():
        conv.weight.copy_(tres.s2d_stem_kernel(k7))
        got = conv(tres.space_to_depth(x))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


# -- forward, statistics and backward against the reference ---------------


@functools.lru_cache(maxsize=None)
def _reference(variant, dtype):
    """The reference's init, then the running statistics of one ``bn``
    training forward of the same weights (flax draws a convolution's
    kernel by its name, which the norms do not change), then in training
    and in eval: the logits, the new statistics and the gradient of
    ``sum(logits * proj)``.  One compiled program a ``(variant, dtype)``,
    shared by its two modes' cases."""
    from stochastic_gradient_push_tpu.models import resnet as jres

    r = np.random.default_rng(4)
    x = r.standard_normal(IMAGES[variant]).astype(np.float32)
    proj = r.standard_normal((x.shape[0], 10)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jmodel = _net(jres, variant, dtype=jdt)
    bn = _net(jres, variant, norm_variant="bn")
    norm = ("BatchNorm" if VARIANTS[variant].get("norm_variant", "bn")
            == "bn" else "ProbeBatchNorm")

    def program(key, x):
        variables = jmodel.init(key, x, train=False)
        _, mut = bn.apply({c: _probe_names(variables[c], "BatchNorm", norm)
                           for c in ("params", "batch_stats")}, x,
                          train=True, mutable=["batch_stats"])
        stats = _probe_names(mut["batch_stats"], norm)
        out = {"variables": {"params": variables["params"],
                             "batch_stats": stats}}
        for mode in ("train", "eval"):
            train = mode == "train"

            def loss(params):
                got = jmodel.apply({"params": params, "batch_stats": stats},
                                   x, train=train,
                                   mutable=["batch_stats"] if train
                                   else False)
                logits, new = got if train else (got, None)
                return jnp.sum(logits * proj), (logits, new)

            (_, (logits, new)), grads = jax.value_and_grad(
                loss, has_aux=True)(variables["params"])
            out[mode] = (logits, None if new is None
                         else new["batch_stats"], grads)
        return out

    out = jax.device_get(jax.jit(program)(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    return x, proj, out


def _probe_names(tree, norm: str, old: str = "BatchNorm"):
    """A flax tree with a block's auto-named ``{old}_{i}`` renamed
    ``{norm}_{i}``."""
    if not isinstance(tree, dict):
        return tree
    return {(norm + k[len(old):] if k.startswith(old + "_") else k):
            _probe_names(v, norm, old) for k, v in tree.items()}


def _port(variant, dtype, variables, x, proj, mode):
    """The port's logits, new running statistics and parameter gradients
    (fp64 numpy, the port's names); ``dtype`` ``"fp64"`` is the oracle."""
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "fp64": torch.float64}[dtype]
    model = _net(tres, variant, dtype=tdt)
    params, stats = vision_params_from_jax(model, variables)
    model.load_state_dict({**params, **stats})
    xt = _nchw(x)
    if dtype == "fp64":
        model, xt = model.double(), xt.double()
    train = mode == "train"
    out = {}
    logits = model(xt, train=train, stats_out=out if train else None)
    (logits * torch.from_numpy(proj).to(logits.dtype)).sum().backward()
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return (logits.detach().double().numpy(),
            {n: t.double().numpy() for n, t in out.items()}, grads, stats)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_stats_and_backward_match_the_reference(dtype, mode):
    """The s2d stem (the norms: ``test_torch_resnet_norms.py``)."""
    check_against_the_reference("s2d", dtype, mode)


def check_against_the_reference(variant, dtype, mode):
    """``variant``'s logits, new running statistics and gradients against
    the reference's, to the fp64-distance tolerance."""
    x, proj, ref = _reference(variant, dtype)
    variables = ref["variables"]
    want, want_new, want_grads = ref[mode]
    want = np.asarray(want, np.float64)
    model = _net(tres, variant)
    want_grads = vision_params_from_jax(model, {"params": want_grads})[0]
    want_stats = ({} if want_new is None else vision_params_from_jax(
        model, {"batch_stats": want_new})[1])
    got, got_stats, got_grads, start = _port(variant, dtype, variables, x,
                                             proj, mode)
    exact, exact_stats, exact_grads, _ = _port(variant, "fp64", variables,
                                               x, proj, mode)
    assert set(got_stats) == set(want_stats) == set(exact_stats)
    assert set(got_grads) == set(want_grads)
    forward = [("logits", got, want, exact)] + [
        (n, got_stats[n], w, exact_stats[n]) for n, w in want_stats.items()]
    backward = [(n + ".grad", got_grads[n], w, exact_grads[n])
                for n, w in want_grads.items()]
    for group in (forward, backward):
        # the reference's own rounding at this conditioning, the largest
        # over the group's outputs
        ref_err = max(_max_err(w, e) for _, _, w, e in group)
        if group is forward:
            assert ref_err <= ORACLE_SLACK[dtype], ref_err
        atol = TOL + 2 * ref_err
        for n, g, w, _ in group:
            np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=0,
                                       atol=atol, err_msg=n)
    if variant == "folded" and mode == "train":
        # the running statistics are written back bit-unchanged
        for n, t in start.items():
            assert np.array_equal(got_stats[n], t.double().numpy()), n


# -- the weight map and the init ----------------------------------------------


def test_probe_norms_map_onto_the_blocks_norms():
    from stochastic_gradient_push_tpu.models import resnet50 as jresnet50

    for variant in ("bn16", "folded"):
        shapes = jax.eval_shape(lambda: jresnet50(
            num_classes=1000, norm_variant=variant, stem_s2d=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=True))
        flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
        names = {"/".join(p.key for p in path) for path, _ in flat}
        assert "Bottleneck_0/ProbeBatchNorm_2/scale" in names
        assert "bn_init/scale" in names
        assert "Bottleneck_0/norm_proj/scale" in names
        variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                 shapes)
        model = tres.resnet50(num_classes=1000, norm_variant=variant,
                              stem_s2d=True)
        params, stats = vision_params_from_jax(model, variables)
        assert len(params) + len(stats) == 161 + 106
        assert params["conv1.weight"].shape == (64, 12, 4, 4)
        assert sum(t.numel() for t in params.values()) == sum(
            p.numel() for p in model.parameters())
        # the wire's reference order follows the flax names
        order = reference_layout(model).order
        assert order.index("layer1.0.conv3.weight") < order.index(
            "layer1.0.bn1.weight")
    # checkpoints do not carry across the variants, as in the reference
    bn = jax.eval_shape(lambda: jresnet50(num_classes=1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    with pytest.raises(ValueError, match="unmapped"):
        vision_params_from_jax(tres.resnet50(norm_variant="bn16"),
                               jax.tree.map(lambda s: np.zeros(s.shape),
                                            bn))


def test_the_s2d_init_is_the_7x7_recipe_transformed():
    """``init_model_params`` draws the s2d stem as the 7x7 stem's kernel
    (fan-out normal, std sqrt(2 / (64 * 49))), then transforms it: the
    front taps are zero, the rest has the 7x7 kernel's spread, as the
    reference's own init."""
    from stochastic_gradient_push_tpu.models import resnet as jres

    model = tres.resnet18(num_classes=10, stem_s2d=True)
    got = init_model_params(model, 5)[0]["conv1.weight"]
    jmodel = jres.resnet18(num_classes=10, stem_s2d=True)
    want = vision_params_from_jax(model, jax.device_get(jax.jit(
        lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))))[0][
        "conv1.weight"]
    for w in (got, want):
        zero = w == 0
        # the 8x8 padded kernel's first row (ky 0, dy 0: channels 0-5
        # in the (dy, dx, c) order) and first column (kx 0, dx 0:
        # channels 0-2 and 6-8)
        assert zero[:, 0:6, 0].all()
        assert zero[:, 0:3, :, 0].all() and zero[:, 6:9, :, 0].all()
        nz = w[~zero]
        assert nz.numel() == 64 * 3 * 49
        ratio = float(nz.std()) / (2.0 / (64 * 49)) ** 0.5
        assert 0.9 < ratio < 1.1, ratio
