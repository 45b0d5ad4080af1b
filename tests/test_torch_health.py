"""Port parity: consensus health signals, the health monitor, the
recovery policy and the trainer with error feedback, faults and health.

* ``health_signals`` over world 4 on converted ResNet-18 (CIFAR stem)
  and LM (d64/L2) params, with grads holding NaN and Inf, an EF residual
  and an overlap FIFO of two slots, against the reference's
  ``health_signals`` compiled under ``shard_map``: every signal within
  1e-6 relative (the sums run in another order).  The probe is the
  reference's (the largest leaf, ties broken by its tree order, read in
  its layout): taking the port's own order and layout instead moves the
  consensus residual (ResNet-18's ties between 3x3x512x512 kernels).
* ``HealthMonitor``: a scripted sequence of signal sets (healthy, a
  residual above the floor, a mass leak, a collapsed weight, NaN
  params and grads, an EF blow-up, a NaN residual) gives the
  reference's lines (``gossip health: {json}``, sorted keys), reports
  and counts, step-time percentiles included.  ``RecoveryPolicy``
  decides as the reference does (cooldown, circuit breaker,
  advise-restore on non-finite values, the ``gossip recovery:`` line)
  with the planner's re-plan ``suggestion`` in each firing.
* ``make_recovery_fn`` against the reference's, synchronous and
  overlap (the FIFO folded and drained): params within 1e-6 relative,
  the weights exactly 1, every rank exactly equal (spread 0), and
  ``Σx/Σw`` kept.
* The ``Trainer`` at world 4 (TinyMLP, SGP, int8 wire with error
  feedback, a fault plan, ``health_every=2`` with a residual floor that
  fires the recovery average) against the reference's ``Trainer`` from
  its own initial state, ``global_avg_every=0``: the CSVs equal outside
  the timing columns (so the loss to its printed digits, and within
  1e-5 relative per step), ps-weight exact, params, momentum and the EF
  residual within 2e-6 but for under 0.1 % of the elements, where an
  ulp between the frameworks' grads met a rounding boundary of the
  int8 code (those within one quantization step, 2e-3), the same
  recovery decisions, and the last health payload (checkpointed in the
  rank files' meta) within 1e-5.
* The image and LM step builders accept ``health_axis`` (the transport)
  and add the signals to the metrics.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.models.convert import (
    reference_layout, train_state_from_jax)
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.resilience import monitor as tmon
from stochastic_gradient_push_torch.resilience import recovery as trec
from stochastic_gradient_push_torch.train import loop as tloop

import test_torch_wire_layout as layout_case

torch.set_num_threads(2)

W = 4
REL = 1e-6


def _ref_signals(tree, grads, ps, res, fifo):
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.resilience.monitor import (
        health_signals)

    def body(p, g, w, e, f):
        out = health_signals(p, g, w, GOSSIP_AXIS, ef_residual=e,
                             in_flight=f)
        return {k: v[None] for k, v in out.items()}

    fn = jax.jit(jax.shard_map(
        body, mesh=make_gossip_mesh(W), in_specs=(P(GOSSIP_AXIS),) * 5,
        out_specs=P(GOSSIP_AXIS)))
    out = jax.device_get(fn(tree, grads, ps, res, fifo))
    for k, v in out.items():
        assert np.all(v == v[0]) or np.all(np.isnan(v)), k
    return {k: float(v[0]) for k, v in out.items()}


@pytest.mark.parametrize("case", ["resnet", "lm"])
def test_health_signals_match_reference(case):
    tree, model, convert = layout_case._case(case)
    rng = np.random.default_rng(5)
    noise = lambda s: rng.standard_normal(s).astype(np.float32)
    grads = jax.tree.map(lambda a: noise(a.shape), tree)
    leaves, treedef = jax.tree.flatten(grads)
    leaves[0].reshape(-1)[:3] = np.nan
    leaves[-1].reshape(-1)[5] = np.inf
    grads = jax.tree.unflatten(treedef, leaves)
    res = jax.tree.map(lambda a: noise(a.shape) * 1e-3, tree)
    ps = rng.uniform(0.5, 1.0, W).astype(np.float32)
    fifo = tuple((jax.tree.map(lambda a: noise(a.shape) * 0.1, tree),
                  rng.uniform(0.0, 0.3, W).astype(np.float32))
                 for _ in range(2))
    want = _ref_signals(tree, grads, ps, res, fifo)

    layout = reference_layout(model)
    tfifo = tuple((convert(p), torch.from_numpy(w)) for p, w in fifo)
    got = tmon.health_signals(convert(tree), convert(grads),
                              torch.from_numpy(ps), tc.StackedTransport(W),
                              ef_residual=convert(res), in_flight=tfifo,
                              layout=layout)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=REL, err_msg=k)
    assert want["nonfinite_grads"] == 4.0
    # the port's own order and layout probe other values
    if case == "resnet":
        own = tmon.health_signals(convert(tree), None, torch.from_numpy(ps),
                                  tc.StackedTransport(W))
        assert float(own["consensus_residual"]) != pytest.approx(
            want["consensus_residual"], rel=1e-3)


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(("info", msg % args if args else msg))

    def warning(self, msg, *args):
        self.lines.append(("warning", msg % args if args else msg))


def _script():
    ok = dict(consensus_residual=0.001, ps_w_min=1.0, ps_w_max=1.0,
              ps_mass_err=0.0, nonfinite_params=0.0, nonfinite_grads=0.0,
              ef_residual_rms=0.002)
    seq = [ok, dict(ok, consensus_residual=0.05),
           dict(ok, consensus_residual=0.07), dict(ok, ps_mass_err=0.01),
           dict(ok, ps_w_min=0.001), ok,
           dict(ok, nonfinite_params=12.0, consensus_residual=float("nan")),
           dict(ok, nonfinite_grads=3.0), dict(ok, ef_residual_rms=0.5),
           dict(ok, ef_residual_rms=float("nan")), ok,
           dict(ok, consensus_residual=0.2), dict(ok, ps_mass_err=0.02),
           dict(ok, consensus_residual=0.3), ok, ok]
    no_ef = dict(ok)
    del no_ef["ef_residual_rms"]
    return seq + [no_ef, dict(no_ef, consensus_residual=1.0)]


@pytest.mark.parametrize("max_recoveries", [0, 2])
def test_monitor_and_policy_match_reference(max_recoveries):
    from stochastic_gradient_push_tpu.resilience import (
        HealthMonitor, RecoveryPolicy)
    from stochastic_gradient_push_tpu.topology import RingGraph

    logs = {"ref": _Log(), "port": _Log()}
    mons = {"ref": HealthMonitor(health_every=3, residual_floor=0.02,
                                 log=logs["ref"]),
            "port": tmon.HealthMonitor(health_every=3, residual_floor=0.02,
                                       log=logs["port"])}
    pols = {"ref": RecoveryPolicy(world=W, topology="ring",
                                  residual_floor=0.02, cooldown_steps=3,
                                  max_recoveries=max_recoveries,
                                  log=logs["ref"]),
            "port": trec.RecoveryPolicy(world=W, topology="ring",
                                        residual_floor=0.02,
                                        cooldown_steps=3,
                                        max_recoveries=max_recoveries,
                                        log=logs["port"])}
    del RingGraph
    for step, sig in enumerate(_script()):
        decided = {}
        for side in ("ref", "port"):
            mons[side].record_step_time(0.1 + 0.01 * step)
            report = mons[side].observe(step, sig)
            decided[side] = (report.reasons, report.payload,
                             pols[side].assess(report) if report.unhealthy
                             else None)
        assert decided["port"][0] == decided["ref"][0], step
        assert json.dumps(decided["port"][1], sort_keys=True) == \
            json.dumps(decided["ref"][1], sort_keys=True), step
        ev_p, ev_r = decided["port"][2], decided["ref"][2]
        if ev_r is None:
            assert ev_p is None
            continue
        assert ev_p.to_dict() == ev_r.to_dict()
        assert (ev_p.suggestion is None) == (ev_p.action != "global-average")
    assert logs["port"].lines == logs["ref"].lines
    assert any("gossip recovery:" in t for _, t in logs["port"].lines)
    for attr in ("reports", "excursions"):
        assert getattr(mons["port"], attr) == getattr(mons["ref"], attr)
    assert json.dumps(mons["port"].last_payload, sort_keys=True) == \
        json.dumps(mons["ref"].last_payload, sort_keys=True)
    for attr in ("recoveries", "last_fired_step"):
        assert getattr(pols["port"], attr) == getattr(pols["ref"], attr)
    assert pols["port"].replan() == pols["ref"].replan()


@pytest.mark.parametrize("overlap", [False, True])
def test_recovery_fn_matches_reference_and_is_exact(overlap):
    from stochastic_gradient_push_tpu.algorithms import sgp as rsgp
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.resilience import (
        make_recovery_fn as ref_fn)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JG, build_schedule as jb)

    rng = np.random.default_rng(8)
    x = {"w": rng.normal(size=(W, 5, 7)).astype(np.float32),
         "b": rng.normal(size=(W, 9)).astype(np.float32)}
    ps = rng.uniform(0.5, 1.5, W).astype(np.float32)
    fifo = tuple(({n: rng.normal(size=a.shape).astype(np.float32)
                   for n, a in x.items()},
                  rng.uniform(0.0, 0.3, W).astype(np.float32))
                 for _ in range(2)) if overlap else None
    ref = ref_fn(rsgp(jb(JG(W)), GOSSIP_AXIS, overlap=overlap,
                      staleness=2 if overlap else 1), make_gossip_mesh(W))
    want = jax.device_get(ref(x, ps, fifo) if overlap else ref(x, ps))

    alg = talg.sgp(tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        W)), tc.StackedTransport(W), overlap=overlap,
        staleness=2 if overlap else 1)
    fn = trec.make_recovery_fn(alg)
    tx = {n: torch.from_numpy(a.copy()) for n, a in x.items()}
    if overlap:
        tfifo = tuple(({n: torch.from_numpy(a) for n, a in p.items()},
                       torch.from_numpy(w)) for p, w in fifo)
        got = fn(tx, torch.from_numpy(ps), tfifo)
    else:
        got = fn(tx, torch.from_numpy(ps))
    np.testing.assert_array_equal(got[1].numpy(), np.ones(W, np.float32))
    mass_w = ps.astype(np.float64).sum()
    for n, a in x.items():
        np.testing.assert_allclose(got[0][n].numpy(), want[0][n], rtol=REL)
        # every rank equal, and the de-biased mean kept
        assert torch.equal(got[0][n], got[0][n][:1].expand_as(got[0][n]))
        total = a.astype(np.float64).sum(0)
        if overlap:
            mass_w = ps.astype(np.float64).sum() + sum(
                w.astype(np.float64).sum() for _, w in fifo)
            total = total + sum(p[n].astype(np.float64).sum(0)
                                for p, _ in fifo)
        np.testing.assert_allclose(got[0][n][0].numpy(), total / mass_w,
                                   rtol=1e-5, atol=1e-6)
    if overlap:
        for p, w in got[2]:
            assert not w.any() and not any(t.any() for t in p.values())


# -- the trainer ------------------------------------------------------------


WB, CLASSES, IMG = 4, 4, 8
HEALTH = dict(push_sum=True, wire_dtype="int8", wire_block=16,
              error_feedback=True, inject_faults="drop:0->1@1:4;seed:5",
              health_every=2, residual_floor=1e-6)


def _trainer_cfg(cls, topo, path, **extra):
    return cls(graph_class=topo.NPeerDynamicDirectedExponentialGraph,
               lr=0.2, warmup=False, lr_schedule={2: 0.5}, batch_size=WB,
               num_epochs=3, num_itr_ignore=0, print_freq=1,
               checkpoint_dir=str(path), num_classes=CLASSES, verbose=False,
               **HEALTH, **extra)


def test_trainer_with_ef_faults_and_health_matches_reference(tmp_path):
    import test_torch_trainer as tt_case
    from stochastic_gradient_push_tpu import topology as jtopo
    from stochastic_gradient_push_tpu.models import TinyMLP
    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh
    from stochastic_gradient_push_tpu.train.loop import (
        Trainer, TrainerConfig)
    from stochastic_gradient_push_tpu.utils.checkpoint import (
        CheckpointManager as JCkpt, ClusterManager as JCluster)
    from stochastic_gradient_push_torch.train.step import make_model
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager, ClusterManager)

    data = tt_case._data()
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = Trainer(_trainer_cfg(TrainerConfig, jtopo, ref_dir),
                  TinyMLP(num_classes=CLASSES), make_gossip_mesh(W),
                  sample_input_shape=(WB, IMG, IMG, 3),
                  cluster_manager=JCluster(JCkpt(str(ref_dir), world_size=W),
                                           install_handlers=False))
    start = jax.device_get(ref.init_state())
    loader, sampler = tt_case._loader(data)
    want, _ = ref.fit(ref.init_state(), loader, sampler, val_loader=loader)
    want = jax.device_get(want)

    model = make_model("tiny_mlp", num_classes=CLASSES,
                       in_features=3 * IMG * IMG)
    port = tloop.Trainer(
        _trainer_cfg(tloop.TrainerConfig, tt, port_dir), model,
        tc.StackedTransport(W),
        cluster_manager=ClusterManager(CheckpointManager(
            str(port_dir), world_size=W, ranks=range(W)),
            install_handlers=False), device="cpu")
    state = train_state_from_jax(start, model=model)
    state = state.replace(gossip=state.gossip.replace(ef_residual={
        n: torch.zeros_like(p) for n, p in state.params.items()})) \
        if hasattr(state, "replace") else _with_zero_residual(state)
    loader, sampler = tt_case._loader(data)
    got, _ = port.fit(state, loader, sampler, val_loader=loader)

    got_csv, ref_csv = tt_case._csv(port_dir), tt_case._csv(ref_dir)
    assert got_csv == ref_csv
    ref_state = train_state_from_jax(want, model=model)
    assert (got.step, got.gossip.phase) == (ref_state.step,
                                            ref_state.gossip.phase)
    assert torch.equal(got.gossip.ps_weight, ref_state.gossip.ps_weight)
    want_res = train_state_from_jax(
        want.replace(params=want.gossip.ef_residual), model=model).params
    for tree, ref_tree in ((got.params, ref_state.params),
                           (got.opt_state, ref_state.opt_state),
                           (got.gossip.ef_residual, want_res)):
        diff = np.concatenate([(tree[n] - r).abs().reshape(-1).numpy()
                               for n, r in ref_tree.items()])
        # 2e-6 but for the rare element whose int8 code flipped: the
        # frameworks' grads and updates part by an ulp, and an ulp at a
        # rounding boundary of q moves the value by one quantization
        # step (the block max / 127 of these ~0.1-scale leaves)
        assert np.mean(diff > 2e-6) < 1e-3 and diff.max() < 2e-3, (
            np.mean(diff > 2e-6), diff.max())
    ref_events = [e.to_dict() for e in ref.recovery_policy.events]
    assert [e.to_dict() for e in port.recovery_policy.events] == ref_events
    assert any(e["action"] == "global-average" for e in ref_events)
    got_h, want_h = port.monitor.last_payload, ref.monitor.last_payload
    assert set(got_h) == set(want_h)
    for k, v in want_h.items():
        if k.startswith("step_p"):
            continue
        if isinstance(v, float):
            assert got_h[k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
        else:
            assert got_h[k] == v, k
    meta = json.loads(torch.load(os.path.join(
        port_dir, f"checkpoint_r0_n{W}.ckpt"), weights_only=True)["meta"])
    assert meta["health"]["step"] == got_h["step"]


def _with_zero_residual(state):
    import dataclasses

    return dataclasses.replace(state, gossip=state.gossip.replace(
        ef_residual={n: torch.zeros_like(p)
                     for n, p in state.params.items()}))


@pytest.mark.parametrize("builder", ["image", "lm"])
def test_step_builders_add_health_signals(builder):
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.train import lm as tlm
    from stochastic_gradient_push_torch.train import step as tstep
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.parallel import wire as tw

    transport = tc.StackedTransport(W)
    alg = talg.sgp(tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        W)), transport, wire=tw.Int8Codec(16), error_feedback=True)
    tx = sgd()
    lrs = LRSchedule(0.1, 2, W)
    if builder == "image":
        model = tstep.make_model("tiny_cnn", num_classes=4)
        step = tstep.build_train_step(model, alg, tx, lrs, 10, 4,
                                      health_axis=transport)
        state = tstep.init_train_state(model, alg, tx, W, seed=0)
        x = torch.randn(W, 2, 8, 8, 3)
        y = torch.randint(0, 4, (W, 2))
    else:
        cfg = TransformerConfig(vocab_size=32, d_model=16, n_layers=1,
                                n_heads=2, d_ff=32)
        step = tlm.build_lm_train_step(tlm.make_model(cfg), alg, tx, lrs,
                                       10, health_axis=transport)
        state = tlm.init_lm_state(cfg, alg, tx, W, seed=0)
        x = torch.randint(0, 32, (W, 2, 8))
        y = torch.randint(0, 32, (W, 2, 8))
    state, m = step(state, x, y)
    for k in tmon.HEALTH_KEYS + (tmon.EF_HEALTH_KEY,):
        assert m[k].dim() == 0 and torch.isfinite(m[k]), k
    assert float(m["ps_mass_err"]) == 0.0
    assert alg.layout is not None and alg.layout.perms
