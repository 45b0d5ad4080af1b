"""Port parity: the ResNet SGP train step (``train/step.py``) at world 4
stacked against the reference's compiled ``shard_train_step`` on its CPU
mesh, from the reference's own init (``train_state_from_jax``) and on the
same numpy batches, for three steps: ResNet-18, 32 px, batch 2, 10
classes, SGP over the n-peer exponential graph, ``sgd(0.9, 1e-4,
nesterov=True)``, ``LRSchedule(0.1, 2, 4, warmup=True)`` (the dry run's
configuration) with the CIFAR stem (``small_images``).  Cases: the plain
step, ``grad_accum=2``, ``label_smoothing=0.1`` and uint8 batches
normalized on the device.

Why the CIFAR stem: with the ImageNet stem at 32 px the last stage's
BatchNorm sees two values per channel, and its backward multiplies
rounding by up to ``1 / sqrt(eps)``.  There the two fp32 frameworks'
first gradients already differ (grad norms 26,066 against 27,492 on
rank 0) and their trajectories part; each framework's forward sits ~2e-3
from an fp64 forward (``tests/test_torch_resnet.py``).  With the CIFAR
stem every BatchNorm sees 32 values or more.  The dry run itself (the
ImageNet stem) runs below through ``dryrun_multichip``.

Tolerances.  The push-sum weight, the phase and the step are exact.
After the first step: losses within 1e-5 relative, grad norms (a sum
over 11 M squares) within 3e-4 relative, params and BatchNorm
statistics within 5e-5.  After three steps the trajectories carry each
framework's rounding: losses within 3e-4 relative, grad norms within
2e-3 relative, params within 4e-4, statistics within 1e-3, and the
port's distance from an fp64 run of its own step at most twice the
reference's (+1e-5): the reference lands 1e-4 to 1.3e-4 from fp64 in
params at these seeds.  The eval step and ``replica_spread`` run on the
reference's own final state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax, vision_params_from_jax)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.run.dryrun import dryrun_multichip
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import step as tstep
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd

torch.set_num_threads(2)

W, B, IMG, C, STEPS = 4, 2, 32, 10, 3
ITR = 100
CASES = {"plain": dict(), "grad_accum": dict(grad_accum=2),
         "label_smoothing": dict(label_smoothing=0.1),
         "uint8": dict()}


def _batches(case):
    rng = np.random.default_rng(len(case))
    if case == "uint8":
        xs = [rng.integers(0, 256, size=(W, B, IMG, IMG, 3)).astype(np.uint8)
              for _ in range(STEPS)]
    else:
        xs = [rng.normal(size=(W, B, IMG, IMG, 3)).astype(np.float32)
              for _ in range(STEPS)]
    ys = [rng.integers(0, C, size=(W, B)).astype(np.int32)
          for _ in range(STEPS)]
    return list(zip(xs, ys))


def _jax_run(batches, eval_batch=None, **kw):
    from stochastic_gradient_push_tpu.algorithms import sgp
    from stochastic_gradient_push_tpu.models import resnet18
    from stochastic_gradient_push_tpu.parallel import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import (
        LRSchedule as JLR, build_eval_step, build_train_step,
        init_train_state, replica_spread, replicate_state,
        sgd as jsgd, shard_eval_step, shard_train_step)

    mesh = make_gossip_mesh(W)
    model = resnet18(num_classes=C, small_images=True)
    alg = sgp(jbuild(JGraph(W, peers_per_itr=1)), GOSSIP_AXIS)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    step = shard_train_step(build_train_step(
        model, alg, tx, JLR(0.1, B, W, warmup=True), itr_per_epoch=ITR,
        num_classes=C, **kw), mesh)
    state = replicate_state(init_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((B, IMG, IMG, 3)), tx, alg),
        W)
    start, states, metrics = jax.device_get(state), [], []
    for x, y in batches:
        state, m = step(state, x, y)
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    extra = {}
    if eval_batch is not None:
        ev = shard_eval_step(build_eval_step(model, alg, C), mesh)
        extra["eval"] = jax.device_get(ev(state, *eval_batch))
        extra["spread"] = replica_spread(jax.device_get(state), alg)
    return start, states, metrics, extra


def _port(dtype=torch.float32, **kw):
    model = tstep.make_model("resnet18", num_classes=C, small_images=True,
                             dtype=dtype)
    alg = talg.sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        W, peers_per_itr=1)), StackedTransport(W))
    step = tstep.build_train_step(
        model, alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.1, B, W, warmup=True), ITR, C, **kw)
    return model, alg, step


def _fp64(state):
    def up(tree):
        return {n: t.double() for n, t in tree.items()}

    return dataclasses.replace(
        state, params=up(state.params), opt_state=up(state.opt_state),
        batch_stats=up(state.batch_stats),
        gossip=state.gossip.replace(ps_weight=state.gossip.ps_weight.double()))


def _err(a: dict, b: dict) -> float:
    return max(float((a[n].double() - b[n].double()).abs().max()) for n in b)


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_reference(case):
    kw = CASES[case]
    batches = _batches(case)
    eval_batch = batches[0] if case == "plain" else None
    start, states, jm, extra = _jax_run(batches, eval_batch, **kw)
    model, alg, step = _port(**kw)
    state = train_state_from_jax(start, model=model)
    for t, ((x, y), want, m_want) in enumerate(zip(batches, states, jm)):
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        first = t == 0
        rtol_loss, rtol_gn = (1e-5, 3e-4) if first else (3e-4, 2e-3)
        np.testing.assert_allclose(m["loss"].numpy(),
                                   np.asarray(m_want["loss"]).reshape(W),
                                   rtol=rtol_loss, err_msg=f"step {t}")
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   np.asarray(m_want["grad_norm"]).reshape(W),
                                   rtol=rtol_gn, err_msg=f"step {t}")
        assert np.float32(m["lr"]) == np.asarray(m_want["lr"]).reshape(-1)[0]
        if first:
            for k in ("top1", "top5"):
                np.testing.assert_array_equal(
                    m[k].numpy(), np.asarray(m_want[k]).reshape(W))
        wp, wb = vision_params_from_jax(model, {
            "params": want.params, "batch_stats": want.batch_stats})
        p_tol, b_tol = (5e-5, 5e-5) if first else (4e-4, 1e-3)
        assert _err(state.params, wp) <= p_tol, (t, _err(state.params, wp))
        assert _err(state.batch_stats, wb) <= b_tol, (
            t, _err(state.batch_stats, wb))
        np.testing.assert_array_equal(
            state.gossip.ps_weight.numpy(),
            np.asarray(want.gossip.ps_weight, np.float32).reshape(W))
        assert state.gossip.phase == int(np.asarray(want.gossip.phase)[0])
        assert state.step == int(np.asarray(want.step)[0]) == t + 1

    # the port's rounding is of the reference's order: its distance from
    # an fp64 run of its own step at most twice the reference's
    model64, _, step64 = _port(dtype=torch.float64, **kw)
    exact = _fp64(train_state_from_jax(start, model=model64))
    for x, y in batches:
        xt = torch.from_numpy(x)
        exact, _ = step64(exact, xt if x.dtype == np.uint8 else xt.double(),
                          torch.from_numpy(y))
    wp, wb = vision_params_from_jax(model, {
        "params": states[-1].params, "batch_stats": states[-1].batch_stats})
    assert _err(state.params, exact.params) <= 2 * _err(
        wp, exact.params) + 1e-5
    assert _err(state.batch_stats, exact.batch_stats) <= 2 * _err(
        wb, exact.batch_stats) + 1e-5

    if eval_batch is not None:
        # the eval step and the spread on the reference's own final state
        final = train_state_from_jax(states[-1], model=model)
        ev = tstep.build_eval_step(model, alg, C)(
            final, *(torch.from_numpy(a) for a in eval_batch))
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(
                ev[k].numpy(), np.asarray(extra["eval"][k]).reshape(W),
                rtol=1e-5, atol=1e-6, err_msg=k)
        spread = tstep.replica_spread(final, alg)
        z = alg.eval_params(final.params, final.gossip)
        flat = np.concatenate([p.double().reshape(W, -1).numpy()
                               for p in z.values()], axis=1)
        dev = np.abs(flat - flat.mean(0))
        exact = {"max_spread": dev.max(), "mean_spread": dev.mean(),
                 "spread_l2": np.linalg.norm(dev) / np.sqrt(W),
                 "param_scale": np.abs(flat).max()}
        for k, v in extra["spread"].items():
            np.testing.assert_allclose(spread[k], exact[k], rtol=1e-5,
                                       err_msg=k)
            # the reference's spread_l2 is numpy's fp32 norm over
            # 11 M elements, off the fp64 value by ~0.1 %
            np.testing.assert_allclose(
                spread[k], v, rtol=1e-2 if k == "spread_l2" else 1e-4,
                err_msg=k)


def test_uint8_batches_normalize_as_the_reference():
    from stochastic_gradient_push_tpu.train.step import _device_normalize

    x = np.random.default_rng(5).integers(0, 256, size=(2, 4, 4, 3)).astype(
        np.uint8)
    got = tstep.normalize_images(torch.from_numpy(x))
    want = np.asarray(jax.jit(_device_normalize)(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    f = torch.ones(2, 3)
    assert tstep.normalize_images(f) is f


def test_unreplicate_takes_one_rank():
    tree = {"a": torch.arange(8).reshape(4, 2),
            "b": ({"c": torch.arange(4)}, [torch.ones(4, 3)])}
    got = tstep.unreplicate(tree, rank=2)
    assert got["a"].tolist() == [4, 5]
    assert int(got["b"][0]["c"]) == 2 and got["b"][1][0].shape == (3,)


@pytest.mark.parametrize("world", [1, 4])
def test_dryrun_multichip_runs_on_cpu(world, capsys):
    out = dryrun_multichip(world, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip({world}): ok")
    assert ("no-op" in line) == (world == 1)
    assert np.isfinite(out["loss"]) and out["step"] == 1
    assert out["ps_weight"] == [1.0] * world
