"""Port parity: the vision models (``models/resnet.py``, ``models/
small.py``), their flax weight map and init (``models/convert.py``) and
the classification metrics (``train/metrics.py``) against the JAX
package, on the CPU.

Forward parity starts from the reference's own init, carried across by
``vision_params_from_jax``, at 32 px and batch 2: logits and the new
BatchNorm running statistics, train and eval.  Tolerance: 1e-5, plus
twice the reference's own distance from an fp64 forward of the same
weights (the port's modules at ``dtype=torch.float64``).  That second
term is ~1e-7 wherever every BatchNorm sees many values; with the
ImageNet stem at 32 px the last stage's BatchNorm sees two values per
channel, the fast variance ``E[x^2] - E[x]^2`` cancels, and each fp32
framework lands ~2e-3 from the fp64 forward (measured: the reference
2.1e-3, the port 1.4e-3 on ResNet-18), so the bound follows the
reference's own rounding there.  The reference's distance is the
largest over the logits and every running statistic of the case.  The
fp64 forward is required within 1e-2 of the reference (5e-2 for the bf16
case, whose activations round to 8 bits), so a wrong architecture cannot
widen the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models import resnet as tres
from stochastic_gradient_push_torch.models import small as tsmall
from stochastic_gradient_push_torch.models.convert import (
    init_model_params, vision_params_from_jax)
from stochastic_gradient_push_torch.train import metrics as tmetrics
from stochastic_gradient_push_torch.train.step import build_train_step

torch.set_num_threads(2)

TOL = 1e-5
# how far the reference may sit from the fp64 forward: fp32 rounding
# (cancelling BatchNorm variance included), or bf16 activations
ORACLE_SLACK = {"fp32": 1e-2, "bf16": 5e-2}


def _models(name, dtype="fp32"):
    """(reference flax module, port module class, port kwargs)."""
    from stochastic_gradient_push_tpu.models import resnet as jres
    from stochastic_gradient_push_tpu.models import small as jsmall

    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    if name == "tiny_cnn":
        return jsmall.TinyCNN(dtype=jdt), tsmall.TinyCNN, dict(dtype=tdt)
    if name == "resnet18":
        return (jres.resnet18(num_classes=10, dtype=jdt),
                tres.resnet18, dict(num_classes=10, dtype=tdt))
    return (jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jres.Bottleneck,
                        num_classes=10, num_filters=8, dtype=jdt),
            lambda **kw: tres.ResNet([1, 1, 1, 1], tres.Bottleneck, **kw),
            dict(num_classes=10, num_filters=8, dtype=tdt))


def _port_forward(cls, kw, params, stats, x, train, fp64=False):
    """The port's logits and new running statistics, as fp64 numpy; with
    ``fp64`` the whole forward runs in float64 (the oracle)."""
    model = cls(**(dict(kw, dtype=torch.float64) if fp64 else kw))
    model.load_state_dict({**params, **stats})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if fp64:
        model, xt = model.double(), xt.double()
    out = {}
    with torch.no_grad():
        logits = model(xt, train=train, stats_out=out if train else None)
    return logits.double().numpy(), {n: t.double().numpy()
                                     for n, t in out.items()}


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name,dtype", [
    ("tiny_cnn", "fp32"), ("resnet18", "fp32"), ("bottleneck", "fp32"),
    ("bottleneck", "bf16")])
def test_forward_and_running_stats_match_reference(name, dtype, mode):
    jmodel, cls, kw = _models(name, dtype)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=True))
    if mode == "eval":
        # non-trivial running statistics: those of one training forward
        _, mut = jmodel.apply(variables, x, train=True,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": jax.device_get(mut["batch_stats"])}
        want, want_stats = jmodel.apply(variables, x, train=False), None
    else:
        want, mut = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        want_stats = vision_params_from_jax(
            cls(**kw), {"batch_stats": jax.device_get(
                mut["batch_stats"])})[1]
    params, stats = vision_params_from_jax(cls(**kw), variables)
    train = mode == "train"
    got, got_stats = _port_forward(cls, kw, params, stats, x, train)
    exact, exact_stats = _port_forward(cls, kw, params, stats, x, train,
                                       fp64=True)
    # the reference's own rounding at this conditioning, over every output
    ref_err = max([_max_err(want, exact)] + [
        _max_err(w, exact_stats[n]) for n, w in (want_stats or {}).items()])
    assert ref_err <= ORACLE_SLACK[dtype], ref_err
    atol = TOL + 2 * ref_err
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=atol)
    if train:
        assert set(got_stats) == set(want_stats) == set(stats)
        for n, w in want_stats.items():
            np.testing.assert_allclose(got_stats[n], w.numpy(), rtol=0,
                                       atol=atol, err_msg=n)


def test_weight_map_covers_resnet50_at_full_width():
    """Every leaf of the reference's ResNet-50 (1000 classes) tree, read
    off ``jax.eval_shape`` without running the model, maps onto the
    port's 161 parameters and 106 buffers, shapes transposed."""
    from stochastic_gradient_push_tpu.models import resnet50 as jresnet50

    shapes = jax.eval_shape(
        lambda: jresnet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=True))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             shapes)
    n_flax = len(jax.tree.leaves(variables))
    model = tres.resnet50(num_classes=1000)
    params, stats = vision_params_from_jax(model, variables)
    assert len(params) + len(stats) == n_flax == 161 + 106
    assert sum(t.numel() for t in params.values()) == 25_557_032
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert params["conv1.weight"].shape == (64, 3, 7, 7)
    assert params["layer2.0.conv2.weight"].shape == (128, 128, 3, 3)
    assert params["layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert params["layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert params["fc.weight"].shape == (1000, 2048)
    with pytest.raises(ValueError, match="unmapped"):
        vision_params_from_jax(model, {"params": {
            **variables["params"], "extra": {"kernel": np.zeros(3)}}})
    partial = dict(variables["params"])
    partial.pop("fc")
    with pytest.raises(ValueError, match="missing"):
        vision_params_from_jax(model, {"params": partial})


def test_weight_map_transposes_every_layout():
    """A leaf's values land transposed: HWIO -> OIHW, [in, out] ->
    [out, in], with leading rank dims kept."""
    model = tsmall.TinyCNN()
    rng = np.random.default_rng(1)
    params, _ = init_model_params(model, 0)
    flax = {"Conv_0": {"kernel": rng.normal(size=(4, 3, 3, 3, 16))},
            "Conv_1": {"kernel": rng.normal(size=(4, 3, 3, 16, 32))},
            "Conv_2": {"kernel": rng.normal(size=(4, 3, 3, 32, 64))},
            "Dense_0": {"kernel": rng.normal(size=(4, 64, 10)),
                        "bias": rng.normal(size=(4, 10))}}
    for i in range(3):
        c = 16 * 2 ** i
        flax[f"BatchNorm_{i}"] = {"scale": rng.normal(size=(4, c)),
                                  "bias": rng.normal(size=(4, c))}
    got, _ = vision_params_from_jax(model, {"params": flax})
    k = flax["Conv_1"]["kernel"]
    np.testing.assert_array_equal(got["conv1.weight"][2, 5, 7, 0, 2],
                                  np.float32(k[2, 0, 2, 7, 5]))
    np.testing.assert_array_equal(got["fc.weight"][1, 3, 9],
                                  np.float32(flax["Dense_0"]["kernel"][1, 9,
                                                                     3]))
    assert set(got) == set(params)


@pytest.mark.parametrize("name", ["resnet18", "bottleneck", "tiny_cnn",
                                  "tiny_mlp"])
def test_init_recipe_matches_reference_distributions(name):
    """The numpy init follows the reference's recipe: constant leaves
    (BatchNorm scale 1, or 0 on a Bottleneck's third norm; zero biases;
    running statistics 0 and 1) equal, random leaves with the
    reference's standard deviation (10 % at >= 512 draws) and mean 0."""
    from stochastic_gradient_push_tpu.models import small as jsmall

    if name == "tiny_mlp":
        jmodel, model = jsmall.TinyMLP(), tsmall.TinyMLP(in_features=192)
        shape = (2, 8, 8, 3)
    else:
        jmodel, cls, kw = _models(name)
        model, shape = cls(**kw), (2, 32, 32, 3)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros(shape), train=True))
    want, want_stats = vision_params_from_jax(model, variables)
    got, got_stats = init_model_params(model, seed=3)
    assert set(got) == set(want) and set(got_stats) == set(want_stats)
    for n, w in {**want, **want_stats}.items():
        g = {**got, **got_stats}[n]
        assert g.shape == w.shape and g.dtype == torch.float32, n
        if float(w.std()) == 0.0:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=n)
        elif w.numel() >= 512:
            ratio = float(g.std()) / float(w.std())
            assert 0.9 < ratio < 1.1, (n, ratio)
            assert abs(float(g.mean())) < 4 * float(w.std()) / g.numel() ** .5
    if name == "bottleneck":
        assert not got["layer1.0.bn3.weight"].any()
        assert got["layer1.0.bn2.weight"].eq(1).all()


def test_metrics_match_reference():
    from stochastic_gradient_push_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(2)
    labels = rng.integers(0, 7, size=(16,)).astype(np.int32)
    # integer logits in a small range: many ties, ranked like the
    # reference's reversed stable argsort
    logits = rng.integers(-2, 3, size=(16, 7)).astype(np.float32)
    for smooth in (0.0, 0.1):
        want = np.asarray(jmetrics.one_hot(labels, 7, smooth))
        got = tmetrics.one_hot(torch.from_numpy(labels), 7, smooth)
        np.testing.assert_array_equal(got.numpy(), want)
        loss = tmetrics.kl_div_loss(torch.from_numpy(logits), got)
        np.testing.assert_allclose(
            float(loss), float(jmetrics.kl_div_loss(logits, want)),
            rtol=1e-6)
    for topk in ((1, 5), (1, 2, 3)):
        want = jmetrics.accuracy_topk(logits, labels, topk=topk)
        got = tmetrics.accuracy_topk(torch.from_numpy(logits),
                                     torch.from_numpy(labels), topk=topk)
        assert [float(a) for a in got] == [float(a) for a in want]


# stem_s2d and norm_variant bn16 / folded are ported
# (tests/test_torch_resnet_variants.py); a norm the reference does not
# have is refused
@pytest.mark.parametrize("kwargs,match,exc", [
    ({"norm_variant": "ln"}, "unknown norm_variant", ValueError),
])
def test_tpu_experiments_are_refused_by_name(kwargs, match, exc):
    with pytest.raises(exc, match=match):
        tres.resnet50(**kwargs)


@pytest.mark.parametrize("kwargs,match", [
    # local_axis is ported: the port's is the local size, so the
    # reference's mesh-axis name is refused by name
    ({"local_axis": "local"}, "local_axis"),
])
def test_unported_step_options_are_refused_by_name(kwargs, match):
    with pytest.raises(ValueError, match=match):
        build_train_step(None, None, None, None, 1, 10, **kwargs)


@pytest.mark.parametrize("kwargs,keys", [
    ({}, ()),
    ({"health_axis": True}, ("consensus_residual", "ps_mass_err",
                             "nonfinite_grads")),
])
def test_step_options_are_threaded_into_the_metrics(kwargs, keys):
    from stochastic_gradient_push_torch import algorithms as talg
    from stochastic_gradient_push_torch import topology as tt
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.train.step import (
        init_train_state, make_model)

    transport = StackedTransport(2)
    if kwargs.get("health_axis"):
        kwargs = {"health_axis": transport}
    alg = talg.sgp(tt.build_schedule(
        tt.NPeerDynamicDirectedExponentialGraph(2)), transport)
    model = make_model("tiny_cnn", num_classes=4)
    step = build_train_step(model, alg, sgd(), LRSchedule(0.1, 2, 2), 10, 4,
                            **kwargs)
    state = init_train_state(model, alg, sgd(), 2, seed=0)
    _, m = step(state, torch.randn(2, 2, 8, 8, 3), torch.randint(0, 4, (2, 2)))
    assert set(keys) <= set(m) and ("consensus_residual" in m) == bool(keys)
