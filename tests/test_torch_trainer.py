"""Port parity: the port's ``train/loop.py::Trainer`` against the
reference's ``Trainer`` on ``TinyMLP`` (8 px, 4 classes) at world 4, for
every algorithm: AllReduce, SGP, OSGP (staleness 2), D-PSGD and AD-PSGD
(bipartite exponential graph), three epochs of three iterations with
validation, on the same numpy data (``data/pipeline.py`` copies, so the
epoch order is the reference's).  The port starts from the reference's
own initial state, carried across by ``models/convert.py::
train_state_from_jax``.

Tolerances.  The step counter, the gossip phase and the push-sum weight
(and the FIFO's weights) are exact.  The CSVs are equal, byte for byte,
in every column but the three timing meters (``BT``, ``NT``, ``DT``).
Final params, momentum and FIFO params within 2e-6: each framework's
fp32 rounding over nine steps (XLA contracts ``p - lr * u`` into one
rounding where the port takes two) puts them 6e-8 (params) and 5e-7
(momentum) apart at these seeds.

Resume equals straight, as ``tests/test_resume_equivalence.py`` holds
the reference: four epochs in one run against two epochs, then a fresh
``Trainer`` that resumes from the per-rank checkpoints and runs the
other two; for SGP and for OSGP at staleness 2.  Params, momentum,
ps-weight and FIFO equal (exactly: both runs take the same ops in the
same order on the CPU).

The harness's parts: ``CosineLRSchedule`` and the step schedule's warmup
bit-equal in float32 to the reference's compiled step, ``ppi_at_epoch``,
``Meter`` (strings and state), the sampler's and loader's epoch order
(with ``fast_forward``), and the per-rank checkpoint files (the
reference's names and meta keys, a round trip with the FIFO).
"""

import csv
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.data.pipeline import (
    DistributedSampler, ShardedLoader)
from stochastic_gradient_push_torch.data.synthetic import (
    synthetic_classification)
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch import topology as ttopo
from stochastic_gradient_push_torch.train import loop as tloop
from stochastic_gradient_push_torch.train.step import make_model
from stochastic_gradient_push_torch.utils.checkpoint import (
    CheckpointManager, ClusterManager)
from stochastic_gradient_push_torch.utils.meter import Meter

torch.set_num_threads(1)

WORLD, BATCH, CLASSES, IMG = 4, 4, 4, 8
EPOCHS = 3
PARAM_ATOL = 2e-6
TIMING = slice(2, 11)   # BT, NT, DT: value, mean, std each
ALGS = {
    "ar": dict(all_reduce=True),
    "sgp": dict(),
    "osgp": dict(overlap=True, staleness=2),
    "dpsgd": dict(push_sum=False),
    "adpsgd": dict(bilat=True),
}


def _graph(topo, alg):
    if alg == "ar":
        return None
    if alg == "adpsgd":
        return topo.DynamicBipartiteExponentialGraph
    return topo.NPeerDynamicDirectedExponentialGraph


def _cfg(cls, topo, path, alg, num_epochs=EPOCHS, resume=False):
    return cls(graph_class=_graph(topo, alg), lr=0.2, warmup=False,
               lr_schedule={2: 0.5}, batch_size=BATCH, num_epochs=num_epochs,
               num_itr_ignore=0, print_freq=1, checkpoint_dir=str(path),
               num_classes=CLASSES, verbose=False, resume=resume,
               **ALGS[alg])


def _data(seed=0):
    return synthetic_classification(WORLD * BATCH * 3, num_classes=CLASSES,
                                    image_size=IMG, seed=seed)


def _loader(data):
    images, labels = data
    sampler = DistributedSampler(len(images), WORLD)
    return ShardedLoader(images, labels, BATCH, sampler), sampler


def _reference_run(path, alg, data):
    from stochastic_gradient_push_tpu import topology as jtopo
    from stochastic_gradient_push_tpu.models import TinyMLP
    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh
    from stochastic_gradient_push_tpu.train.loop import (
        Trainer, TrainerConfig)
    from stochastic_gradient_push_tpu.utils.checkpoint import (
        CheckpointManager as JCkpt, ClusterManager as JCluster)

    cluster = JCluster(JCkpt(str(path), world_size=WORLD),
                       install_handlers=False)
    trainer = Trainer(_cfg(TrainerConfig, jtopo, path, alg),
                      TinyMLP(num_classes=CLASSES), make_gossip_mesh(WORLD),
                      sample_input_shape=(BATCH, IMG, IMG, 3),
                      cluster_manager=cluster)
    state = trainer.init_state()
    start = jax.device_get(state)
    loader, sampler = _loader(data)
    state, _ = trainer.fit(state, loader, sampler, val_loader=loader)
    return start, jax.device_get(state)


def _port_trainer(path, alg, num_epochs=EPOCHS, resume=False):
    cluster = ClusterManager(CheckpointManager(
        str(path), world_size=WORLD, ranks=range(WORLD)),
        install_handlers=False)
    model = make_model("tiny_mlp", num_classes=CLASSES,
                       in_features=3 * IMG * IMG)
    cfg = _cfg(tloop.TrainerConfig, ttopo, path, alg, num_epochs, resume)
    return model, tloop.Trainer(cfg, model, StackedTransport(WORLD),
                                cluster_manager=cluster, device="cpu")


def _csv(path):
    with open(os.path.join(path, f"out_r0_n{WORLD}.csv")) as f:
        rows = list(csv.reader(f))
    head, body = rows[:5], rows[5:]
    return head, [r[:TIMING.start] + r[TIMING.stop:] for r in body]


def _assert_state_close(got, want_np, model):
    want = train_state_from_jax(want_np, model=model)
    assert got.step == want.step
    assert got.gossip.phase == want.gossip.phase
    assert torch.equal(got.gossip.ps_weight, want.gossip.ps_weight)
    for tree in ("params", "opt_state"):
        g, w = getattr(got, tree), getattr(want, tree)
        for n in w:
            torch.testing.assert_close(g[n], w[n], rtol=0, atol=PARAM_ATOL)
    assert len(got.gossip.in_flight) == len(want.gossip.in_flight)
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        assert torch.equal(gw, ww)
        for n in wp:
            torch.testing.assert_close(gp[n], wp[n], rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("alg", list(ALGS))
def test_trainer_matches_reference(tmp_path, alg):
    data = _data()
    start, want = _reference_run(tmp_path / "ref", alg, data)
    model, trainer = _port_trainer(tmp_path / "port", alg)
    assert trainer.make_algorithm(1).name == {
        "ar": "ar", "sgp": "sgp", "osgp": "sgp", "dpsgd": "dpsgd",
        "adpsgd": "adpsgd"}[alg]
    state = train_state_from_jax(start, model=model)
    loader, sampler = _loader(data)
    state, result = trainer.fit(state, loader, sampler, val_loader=loader)
    _assert_state_close(state, want, model)
    got, ref = _csv(tmp_path / "port"), _csv(tmp_path / "ref")
    assert got == ref
    # 3 epochs: a row per iteration, the epoch's closing row, a val row
    assert len(got[1]) == EPOCHS * 5
    # one checkpoint file per rank, drained
    for r in range(WORLD):
        assert os.path.isfile(tmp_path / "port" /
                              f"checkpoint_r{r}_n{WORLD}.ckpt")
    assert result["final_prec1"] >= 0


def _port_fit(path, alg, num_epochs, resume=False, seed=1):
    model, trainer = _port_trainer(path, alg, num_epochs, resume)
    loader, sampler = _loader(_data(seed))
    state, _ = trainer.fit(trainer.init_state(), loader, sampler,
                           val_loader=loader)
    return state


@pytest.mark.parametrize("alg", ["sgp", "osgp"])
def test_resume_matches_straight_run(tmp_path, alg):
    straight = _port_fit(tmp_path / "a", alg, 4)
    _port_fit(tmp_path / "b", alg, 2)
    resumed = _port_fit(tmp_path / "b", alg, 4, resume=True)
    assert resumed.step == straight.step == 4 * 3
    assert resumed.gossip.phase == straight.gossip.phase
    assert torch.equal(resumed.gossip.ps_weight, straight.gossip.ps_weight)
    for tree in ("params", "opt_state"):
        for n, t in getattr(straight, tree).items():
            assert torch.equal(getattr(resumed, tree)[n], t), (tree, n)
    assert len(resumed.gossip.in_flight) == (2 if alg == "osgp" else 0)
    for (rp, rw), (sp, sw) in zip(resumed.gossip.in_flight,
                                  straight.gossip.in_flight):
        assert torch.equal(rw, sw)
        assert all(torch.equal(rp[n], sp[n]) for n in sp)


@pytest.mark.parametrize("total_epochs,warmup,batch", [
    (7, True, 32), (9, True, 256), (90, True, 64), (3, False, 8)])
def test_cosine_lr_bit_equal_compiled_reference(total_epochs, warmup, batch):
    """``CosineLRSchedule`` against the value the reference's compiled
    step computes (``itr_per_epoch`` a compile-time constant)."""
    from stochastic_gradient_push_tpu.train.lr import CosineLRSchedule as J
    from stochastic_gradient_push_torch.train.lr import CosineLRSchedule

    for ipe in (1, 3, 7, 100, 391):
        ref = J(0.1, batch, 4, total_epochs, warmup=warmup)
        port = CosineLRSchedule(0.1, batch, 4, total_epochs, warmup=warmup)
        f = jax.jit(lambda st: ref(st // ipe, st % ipe, ipe))
        for st in range(0, ipe * (total_epochs + 2), max(1, ipe // 5)):
            got = port(st // ipe, st % ipe, ipe)
            assert got.dtype == np.float32
            assert got == np.float32(f(st)), (ipe, st)


def test_step_lr_warmup_bit_equal_compiled_reference():
    from stochastic_gradient_push_tpu.train.lr import LRSchedule as J
    from stochastic_gradient_push_torch.train.lr import LRSchedule

    for batch in (2, 32, 256):
        for ipe in (1, 3, 7, 100):
            ref = J(0.1, batch, 4, {2: 0.1, 6: 0.5}, warmup=True)
            port = LRSchedule(0.1, batch, 4, {2: 0.1, 6: 0.5}, warmup=True)
            f = jax.jit(lambda st: ref(st // ipe, st % ipe, ipe))
            for st in range(0, ipe * 8, max(1, ipe // 9)):
                assert port(st // ipe, st % ipe, ipe) == np.float32(f(st))


def test_ppi_at_epoch_matches_reference():
    from stochastic_gradient_push_tpu.train.lr import ppi_at_epoch as jppi
    from stochastic_gradient_push_torch.train.lr import ppi_at_epoch

    sched = {0: 1, 3: 2, 7: 4}
    assert [ppi_at_epoch(sched, e) for e in range(10)] == [
        jppi(sched, e) for e in range(10)]
    with pytest.raises(ValueError) as want:
        jppi({2: 1}, 1)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ppi_at_epoch({2: 1}, 1)


def test_meter_matches_reference():
    from stochastic_gradient_push_tpu.utils.meter import Meter as J
    from stochastic_gradient_push_torch.utils.meter import Meter

    rng = np.random.default_rng(0)
    for kw in (dict(), dict(stateful=True), dict(csv_format=False,
                                                 ptag="Loss")):
        ref, port = J(**kw), Meter(**kw)
        for _ in range(20):
            v, n = float(rng.normal()), int(rng.integers(1, 5))
            ref.update(v, n)
            port.update(v, n)
            assert str(port) == str(ref)
        assert port.state_dict() == ref.state_dict()
        assert Meter(init_dict=ref.state_dict()).state_dict() == \
            J(init_dict=ref.state_dict()).state_dict()


@pytest.mark.parametrize("n,world,batch", [(48, 4, 4), (50, 4, 3),
                                           (7, 8, 1)])
def test_sampler_and_loader_order_match_reference(n, world, batch):
    from stochastic_gradient_push_tpu.data import (
        DistributedSampler as JS, ShardedLoader as JL)

    images = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    labels = np.arange(n, dtype=np.int32)
    js, ts = JS(n, world), DistributedSampler(n, world)
    jl, tl = JL(images, labels, batch, js), ShardedLoader(images, labels,
                                                          batch, ts)
    assert len(tl) == len(jl)
    for epoch in (0, 1, 47 * 90 + 3):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        np.testing.assert_array_equal(ts.all_indices(), js.all_indices())
        for skip in (0, 1):
            jl.fast_forward(skip)
            tl.fast_forward(skip)
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl) - skip
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def test_checkpoint_round_trip_and_reference_names(tmp_path):
    """Per-rank files under the reference's names and meta keys; restore
    rebuilds the rank-stacked state, FIFO included; a FIFO of another
    depth is refused."""
    model, trainer = _port_trainer(tmp_path, "osgp")
    state = trainer.init_state()
    g = torch.Generator().manual_seed(0)
    state = dataclasses.replace(
        state, step=5,
        params={n: torch.randn(p.shape, generator=g)
                for n, p in state.params.items()},
        gossip=state.gossip.replace(phase=5, ps_weight=torch.rand(
            WORLD, generator=g), in_flight=tuple(
            ({n: torch.randn(p.shape, generator=g)
              for n, p in state.params.items()},
             torch.rand(WORLD, generator=g))
            for _ in state.gossip.in_flight)))
    ckpt = trainer.cluster.ckpt
    meta = trainer._ckpt_meta(3, 1, 12.5, 0.0, (Meter(),) * 3)
    # the reference's meta keys (its train/loop.py::_ckpt_meta)
    assert set(meta) == {"epoch", "itr", "best_prec1", "elapsed_time",
                         "batch_meter", "nn_meter", "data_meter"}
    written = ckpt.save(state, meta, epoch_id=3, is_best=True)
    assert [os.path.basename(p) for p in written] == [
        f"ep3_checkpoint_r{r}_n{WORLD}.ckpt" for r in range(WORLD)]
    for r in range(WORLD):
        assert (tmp_path / f"checkpoint_r{r}_n{WORLD}.ckpt").is_file()
        assert (tmp_path / f"model_best_r{r}_n{WORLD}.ckpt").is_file()
    restored, got_meta = ckpt.restore(trainer.init_state())
    assert got_meta["epoch"] == 3 and got_meta["itr"] == 1
    assert (restored.step, restored.gossip.phase) == (5, 5)
    assert torch.equal(restored.gossip.ps_weight, state.gossip.ps_weight)
    for n in state.params:
        assert torch.equal(restored.params[n], state.params[n])
    for (rp, rw), (sp, sw) in zip(restored.gossip.in_flight,
                                  state.gossip.in_flight):
        assert torch.equal(rw, sw)
        assert all(torch.equal(rp[n], sp[n]) for n in sp)
    _, sync = _port_trainer(tmp_path, "sgp")
    with pytest.raises(ValueError, match="FIFO depth"):
        ckpt.restore(sync.init_state())
    assert ckpt.discover_worlds() == []
