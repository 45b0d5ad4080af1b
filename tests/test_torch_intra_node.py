"""Port parity: intra-node averaging (``nprocs_per_node``, the step's
``local_axis``) against the reference's ``(node, local)`` mesh.

* The layout (``parallel/mesh.py``): the node count of the reference's
  mesh, device row ``r`` on node ``r // L`` as in its mesh-flat order,
  and its ``ValueError`` for a world that does not divide.
* The step: the port's ``build_train_step(local_axis=2)`` at 4 nodes × 2
  local against the reference's compiled ``shard_train_step(...,
  NODE_AXIS, LOCAL_AXIS)`` on ``make_hierarchical_mesh(2, 8)``, three
  steps from the reference's own init (``train_state_from_jax``), on
  ``tiny_cnn`` (BatchNorm) and ``tiny_mlp``, for SGP, OSGP at staleness 1
  and AllReduce; then the eval step on the reference's final state.
  Tolerances are ``tests/test_torch_resnet_step.py``'s: after the first
  step losses 1e-5 relative, grad norms 3e-4 relative, params, momentum
  and BatchNorm statistics 5e-5; after three, 3e-4, 2e-3, 4e-4 (params
  and momentum) and 1e-3 (statistics); the eval metrics 1e-5 relative.
  The push-sum weight, the phase, the step, the LR and the first step's
  accuracies are exact.  (The two frameworks land ~1e-8 apart in params
  and ~2e-7 in statistics at these seeds.)
* The reference's wider-batch identity: on the BN-free ``tiny_mlp`` one
  step at ``local_axis=2`` with batch B equals the flat step with batch
  2B (its tolerance, rtol 2e-4 / atol 2e-5).
* One node is AllReduce: ``local_axis`` = world = 4 against AllReduce
  at world 4 for three steps: params within the step tolerance above,
  and the node's running statistics the mean over ranks of AllReduce's
  (5e-5).
* The Trainer at world 8 = 4 nodes × 2 local (``tiny_mlp``, SGP, per-rank
  CSVs) against the reference's ``Trainer`` on the hierarchical mesh
  from the same init: every rank CSV equal outside its timing columns,
  the files named ``_n8`` one per node, the final state within the
  step tolerance (ps-weight exact).
* Refusals: batch rows that are not nodes × local, a ``local_axis`` that
  is not a size, a node size below one, and the Trainer's
  ``nprocs_per_node`` below one or a batch that is not its nodes × L
  rows (``ValueError``).
"""

import csv
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as ttopo
from stochastic_gradient_push_torch.data.pipeline import (
    DistributedSampler, ShardedLoader)
from stochastic_gradient_push_torch.data.synthetic import (
    synthetic_classification)
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax)
from stochastic_gradient_push_torch.parallel import mesh as tmesh
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.train import loop as tloop
from stochastic_gradient_push_torch.train import step as tstep
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
from stochastic_gradient_push_torch.utils.checkpoint import (
    CheckpointManager, ClusterManager)

torch.set_num_threads(1)

NODES, LOCAL, B, IMG, C, STEPS = 4, 2, 4, 8, 10, 3
ITR = 100
# tests/test_torch_resnet_step.py's tolerances: (first step, after three)
TOL_LOSS = (1e-5, 3e-4)
TOL_GN = (3e-4, 2e-3)
TOL_PARAM = (5e-5, 4e-4)
TOL_STATS = (5e-5, 1e-3)
TOL_EVAL = 1e-5
# the reference's wider-batch identity (tests/test_hierarchical.py)
WIDE_RTOL, WIDE_ATOL = 2e-4, 2e-5
ALGS = ("sgp", "osgp", "ar")
TIMING = slice(2, 11)


def _batches(rows, batch, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, batch, IMG, IMG, 3)).astype(np.float32),
             rng.integers(0, C, size=(rows, batch)).astype(np.int32))
            for _ in range(steps)]


def _jax_model(name):
    from stochastic_gradient_push_tpu.models import TinyCNN, TinyMLP

    return (TinyCNN if name == "tiny_cnn" else TinyMLP)(num_classes=C)


def _port_model(name):
    kw = {"in_features": 3 * IMG * IMG} if name == "tiny_mlp" else {}
    return tstep.make_model(name, num_classes=C, **kw)


def _jax_alg(alg, nodes, axis):
    from stochastic_gradient_push_tpu import algorithms as ja
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph, build_schedule)

    if alg == "ar":
        return ja.all_reduce(axis)
    sched = build_schedule(JGraph(nodes, peers_per_itr=1))
    return ja.osgp(sched, axis, staleness=1) if alg == "osgp" else ja.sgp(
        sched, axis)


def _port_alg(alg, nodes):
    transport = StackedTransport(nodes)
    if alg == "ar":
        return talg.all_reduce(transport)
    sched = ttopo.build_schedule(ttopo.NPeerDynamicDirectedExponentialGraph(
        nodes, peers_per_itr=1))
    return (talg.osgp(sched, transport, staleness=1) if alg == "osgp"
            else talg.sgp(sched, transport))


def _jax_run(model_name, alg_name, batches):
    """The reference's compiled step on its (node, local) mesh: start,
    states, metrics, and the eval metrics on the final state over the
    first batch."""
    from stochastic_gradient_push_tpu.parallel import (
        LOCAL_AXIS, NODE_AXIS, make_hierarchical_mesh)
    from stochastic_gradient_push_tpu.train import (
        LRSchedule as JLR, build_eval_step, build_train_step,
        init_train_state, replicate_state, sgd as jsgd, shard_eval_step,
        shard_train_step)

    mesh = make_hierarchical_mesh(LOCAL, NODES * LOCAL)
    model = _jax_model(model_name)
    alg = _jax_alg(alg_name, NODES, NODE_AXIS)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    step = shard_train_step(build_train_step(
        model, alg, tx, JLR(0.1, B, NODES * LOCAL, warmup=True),
        itr_per_epoch=ITR, num_classes=C, local_axis=LOCAL_AXIS), mesh,
        NODE_AXIS, LOCAL_AXIS)
    state = replicate_state(init_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((B, IMG, IMG, 3)), tx, alg),
        NODES)
    start, states, metrics = jax.device_get(state), [], []
    for x, y in batches:
        state, m = step(state, x, y)
        states.append(jax.device_get(state))
        metrics.append(jax.device_get(m))
    ev = shard_eval_step(build_eval_step(model, alg, C), mesh, NODE_AXIS,
                         LOCAL_AXIS)
    return start, states, metrics, jax.device_get(ev(state, *batches[0]))


def _port_step(model, alg, local, world):
    return tstep.build_train_step(
        model, alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.1, B, world, warmup=True), ITR, C, local_axis=local)


def _err(a: dict, b: dict) -> float:
    return max((float((a[n].double() - b[n].double()).abs().max())
                for n in b), default=0.0)


def _assert_state_close(got, want, t, what=""):
    """``got`` (a port state) against ``want`` (the reference's, carried
    across) after step index ``t``."""
    i = min(t, 1)
    assert got.step == want.step and got.gossip.phase == want.gossip.phase
    assert torch.equal(got.gossip.ps_weight, want.gossip.ps_weight), what
    assert _err(got.params, want.params) <= TOL_PARAM[i], (what, t)
    assert _err(got.opt_state, want.opt_state) <= TOL_PARAM[i], (what, t)
    assert _err(got.batch_stats, want.batch_stats) <= TOL_STATS[i], (what, t)
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        assert torch.equal(gw, ww), what
        assert _err(gp, wp) <= TOL_PARAM[i], (what, t)


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("local,world", [(1, 8), (2, 8), (4, 8), (8, 8),
                                         (3, 6)])
def test_layout_is_the_reference_mesh_order(local, world):
    from stochastic_gradient_push_tpu.parallel import (
        make_gossip_mesh, make_hierarchical_mesh)

    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, NODE_AXIS)

    nodes = tmesh.make_hierarchical_layout(local, world)
    ref = (make_hierarchical_mesh(local, world) if local > 1
           else make_gossip_mesh(world))
    assert nodes == ref.shape[NODE_AXIS if local > 1 else GOSSIP_AXIS]
    # the step puts device row r on node r // local: the reference's
    # mesh-flat order d = node * local + l
    ids = np.vectorize(lambda d: d.id)(ref.devices).reshape(nodes, local)
    for node in range(nodes):
        assert [r for r in range(world) if r // local == node] \
            == ids[node].tolist()


@pytest.mark.parametrize("local,world", [(3, 8), (4, 6), (5, 8)])
def test_layout_refuses_an_indivisible_world_as_the_reference(local, world):
    from stochastic_gradient_push_tpu.parallel import make_hierarchical_mesh

    with pytest.raises(ValueError) as want:
        make_hierarchical_mesh(local, world)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tmesh.make_hierarchical_layout(local, world)


@pytest.mark.parametrize("local", [0, -2])
def test_layout_refuses_a_node_size_below_one(local):
    with pytest.raises(ValueError, match="nprocs_per_node must be >= 1"):
        tmesh.make_hierarchical_layout(local, 8)


# -- the step -----------------------------------------------------------------

@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("model_name", ["tiny_cnn", "tiny_mlp"])
def test_step_matches_reference(model_name, alg):
    batches = _batches(NODES * LOCAL, B)
    start, states, jm, jeval = _jax_run(model_name, alg, batches)
    model = _port_model(model_name)
    palg = _port_alg(alg, NODES)
    step = _port_step(model, palg, LOCAL, NODES * LOCAL)
    state = train_state_from_jax(start, model=model)
    assert state.params[next(iter(state.params))].shape[0] == NODES
    for t, ((x, y), want, m_want) in enumerate(zip(batches, states, jm)):
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        i = min(t, 1)
        for k, rtol in (("loss", TOL_LOSS[i]), ("grad_norm", TOL_GN[i])):
            np.testing.assert_allclose(
                m[k].numpy(), np.asarray(m_want[k]).reshape(NODES),
                rtol=rtol, err_msg=f"{k} step {t}")
        assert np.float32(m["lr"]) == np.asarray(m_want["lr"]).reshape(-1)[0]
        if t == 0:
            for k in ("top1", "top5"):
                np.testing.assert_array_equal(
                    m[k].numpy(), np.asarray(m_want[k]).reshape(NODES))
        _assert_state_close(state, train_state_from_jax(want, model=model),
                            t, f"{model_name} {alg}")
        assert state.step == t + 1

    final = train_state_from_jax(states[-1], model=model)
    ev = tstep.build_eval_step(model, palg, C, local_axis=LOCAL)(
        final, *(torch.from_numpy(a) for a in batches[0]))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(ev[k].numpy(),
                                   np.asarray(jeval[k]).reshape(NODES),
                                   rtol=TOL_EVAL, atol=1e-6, err_msg=k)


def test_local_step_equals_the_wider_batch():
    """The reference's identity: with no BatchNorm, exact local
    averaging over 2 rows of B is one row of 2B."""
    model = _port_model("tiny_mlp")
    (x, y), = _batches(NODES * LOCAL, B, steps=1, seed=1)
    states = {}
    for local in (LOCAL, None):
        alg = _port_alg("sgp", NODES)
        state = tstep.init_train_state(model, alg, sgd(0.9, 1e-4), NODES,
                                       seed=0)
        step = tstep.build_train_step(
            model, alg, sgd(0.9, 1e-4), LRSchedule(0.1, B, NODES * LOCAL),
            10, C, local_axis=local)
        xs, ys = torch.from_numpy(x), torch.from_numpy(y)
        if local is None:
            xs = xs.reshape(NODES, LOCAL * B, IMG, IMG, 3)
            ys = ys.reshape(NODES, LOCAL * B)
        states[local], _ = step(state, xs, ys)
    for n, t in states[LOCAL].params.items():
        torch.testing.assert_close(t, states[None].params[n],
                                   rtol=WIDE_RTOL, atol=WIDE_ATOL)


def test_one_node_is_all_reduce():
    """``local_axis`` = world: the node averages every row exactly, as
    AllReduce at that world does; the node's running statistics are the
    mean of AllReduce's ranks'."""
    world = 4
    model = _port_model("tiny_cnn")
    batches = _batches(world, B)
    runs = {}
    for local, nodes in ((world, 1), (None, world)):
        alg = talg.all_reduce(StackedTransport(nodes))
        state = tstep.init_train_state(model, alg, sgd(0.9, 1e-4), nodes,
                                       seed=0)
        step = _port_step(model, alg, local, world)
        for x, y in batches:
            state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
        runs[local] = state
    node, ar = runs[world], runs[None]
    for n, t in ar.params.items():
        assert _err({n: node.params[n].expand_as(t)}, {n: t}) <= \
            TOL_PARAM[1], n
        # AllReduce keeps its ranks equal
        assert torch.equal(t, t[:1].expand_as(t)), n
    for n, t in ar.batch_stats.items():
        assert _err({n: node.batch_stats[n][0]}, {n: t.mean(0)}) <= \
            TOL_STATS[0], n


@pytest.mark.parametrize("rows", [4, 6, 10])
def test_step_refuses_rows_that_are_not_nodes_times_local(rows):
    model = _port_model("tiny_mlp")
    alg = _port_alg("sgp", NODES)
    state = tstep.init_train_state(model, alg, sgd(0.9), NODES, seed=0)
    (x, y), = _batches(rows, B, steps=1)
    for build in (lambda: _port_step(model, alg, LOCAL, NODES * LOCAL),
                  lambda: (lambda s, a, b: tstep.build_eval_step(
                      model, alg, C, local_axis=LOCAL)(s, a, b))):
        with pytest.raises(ValueError, match="local_axis=2"):
            build()(state, torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("local_axis", ["local", 0, -2, 1.5, True])
def test_local_axis_is_a_size(local_axis):
    with pytest.raises(ValueError, match="local_axis is the local size"):
        tstep.build_train_step(None, None, None, None, 1, C,
                               local_axis=local_axis)
    with pytest.raises(ValueError, match="local_axis is the local size"):
        tstep.build_eval_step(None, None, C, local_axis=local_axis)


# -- the Trainer --------------------------------------------------------------

EPOCHS = 2


def _cfg(cls, topo, path, **kw):
    return cls(graph_class=topo.NPeerDynamicDirectedExponentialGraph,
               lr=0.2, warmup=True, lr_schedule={1: 0.5}, batch_size=B,
               num_epochs=EPOCHS, num_itr_ignore=0, print_freq=1,
               checkpoint_dir=str(path), num_classes=C, verbose=False,
               per_rank_csv=True, nprocs_per_node=LOCAL, **kw)


def _data_loader():
    world = NODES * LOCAL
    images, labels = synthetic_classification(world * B * 3, num_classes=C,
                                              image_size=IMG, seed=0)
    sampler = DistributedSampler(len(images), world)
    return ShardedLoader(images, labels, B, sampler), sampler


def _csvs(path, ranks):
    out = {}
    for r in ranks:
        with open(os.path.join(path, f"out_r{r}_n{NODES * LOCAL}.csv")) as f:
            rows = list(csv.reader(f))
        out[r] = rows[:5] + [row[:TIMING.start] + row[TIMING.stop:]
                             for row in rows[5:]]
    return out


def test_trainer_matches_reference_on_the_hierarchical_mesh(tmp_path):
    from stochastic_gradient_push_tpu import topology as jtopo
    from stochastic_gradient_push_tpu.models import TinyMLP
    from stochastic_gradient_push_tpu.parallel import make_hierarchical_mesh
    from stochastic_gradient_push_tpu.train.loop import (
        Trainer, TrainerConfig)
    from stochastic_gradient_push_tpu.utils.checkpoint import (
        CheckpointManager as JCkpt, ClusterManager as JCluster)

    world = NODES * LOCAL
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jtrainer = Trainer(
        _cfg(TrainerConfig, jtopo, ref_dir),
        TinyMLP(num_classes=C), make_hierarchical_mesh(LOCAL, world),
        sample_input_shape=(B, IMG, IMG, 3),
        cluster_manager=JCluster(JCkpt(str(ref_dir), world_size=world),
                                 install_handlers=False))
    jstate = jtrainer.init_state()
    start = jax.device_get(jstate)
    loader, sampler = _data_loader()
    want, _ = jtrainer.fit(jstate, loader, sampler, val_loader=loader)

    model = _port_model("tiny_mlp")
    trainer = tloop.Trainer(
        _cfg(tloop.TrainerConfig, ttopo, port_dir), model,
        StackedTransport(NODES), device="cpu",
        cluster_manager=ClusterManager(CheckpointManager(
            str(port_dir), world_size=world, ranks=range(NODES)),
            install_handlers=False))
    assert (trainer.gossip_world, trainer.world_size) == (NODES, world)
    loader, sampler = _data_loader()
    state, _ = trainer.fit(train_state_from_jax(start, model=model), loader,
                           sampler, val_loader=loader)
    _assert_state_close(state, train_state_from_jax(
        jax.device_get(want), model=model), 1, "trainer")
    got, ref = _csvs(port_dir, range(NODES)), _csvs(ref_dir, range(NODES))
    assert got == ref
    assert got[0][1] == ["World-Size", str(world)]
    assert len(got[0]) == 5 + EPOCHS * 5
    assert sorted(p for p in os.listdir(port_dir) if p.startswith("check")) \
        == [f"checkpoint_r{r}_n{world}.ckpt" for r in range(NODES)]


@pytest.mark.parametrize("local,rows,match", [
    (0, None, "nprocs_per_node must be >= 1"),
    (LOCAL, NODES, "4 batch rows for 4 node rows of local_axis=2"),
    (LOCAL, NODES * LOCAL + LOCAL, "10 batch rows for 4 node rows"),
])
def test_trainer_refuses_a_bad_node_size_or_batch(local, rows, match):
    """A node size below one fails at construction; the Trainer's step
    takes its transport's nodes × ``nprocs_per_node`` batch rows only."""
    cfg = tloop.TrainerConfig(
        nprocs_per_node=local, num_classes=C,
        graph_class=ttopo.NPeerDynamicDirectedExponentialGraph)
    with pytest.raises(ValueError, match=match):
        trainer = tloop.Trainer(cfg, _port_model("tiny_mlp"),
                                StackedTransport(NODES), device="cpu")
        _, step = trainer._train_fn(1, ITR)
        (x, y), = _batches(rows, B, steps=1)
        step(trainer.init_state(), torch.from_numpy(x), torch.from_numpy(y))


def test_trainer_sorts_its_two_worlds():
    """The graph, the recovery policy and the CSV ranks take the node
    world; the file names, the CSV preamble and the LR the device
    world."""
    cfg = tloop.TrainerConfig(
        nprocs_per_node=LOCAL, per_rank_csv=True, health_every=2,
        graph_class=ttopo.NPeerDynamicDirectedExponentialGraph)
    trainer = tloop.Trainer(cfg, _port_model("tiny_mlp"),
                            StackedTransport(NODES), device="cpu")
    assert (trainer.gossip_world, trainer.world_size) == (NODES, 8)
    assert trainer.local_axis == LOCAL
    assert trainer.recovery_policy.world == NODES
    assert trainer.make_algorithm(1).schedule.world_size == NODES
    assert trainer._csv_ranks == tuple(range(NODES))
    assert trainer._fname(3).endswith("out_r3_n8.csv")
