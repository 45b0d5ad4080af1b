"""``scan_steps``: the reference's chunked training loop
(``train/loop.py:1021-1160`` there) in the port's ``Trainer`` and in
``run/gossip_sgd.py``.

After the warm-up window (``num_itr_ignore``, single steps) the steps
run in chunks of ``scan_steps``: the chunk's batches stacked on the host
and sent to the device in one copy, its steps back to back, its metrics
read once.  A cap tail shorter than a chunk runs as single steps, and so
do a loader tail's extra batches.  The port runs a chunk as eager steps,
so on the CPU:

* **``scan_steps`` 4 is ``scan_steps`` 1, bit for bit**: the CSV in
  every column but the three host-clock meters, and the final state
  (params, momentum, step, phase, push-sum weight, the FIFO), for SGP
  and for OSGP at staleness 2 (its in-flight shares carry from step to
  step inside a chunk), in the Trainer and on the command line, and
  under torchrun (2 processes, each stacking its own rows) against the
  stacked run.
* **Against the reference's scanned run** (its ``Trainer`` at
  ``scan_steps`` 4, ``lax.scan`` over ``shard_scanned_train_step``):
  ``test_torch_trainer.py``'s tolerances, the CSV equal outside timing,
  params and momentum within 2e-6, step, phase and push-sum weight
  exactly.
* **Chunk boundaries**: the chunk sizes a run takes (a warm-up, a cap
  tail, a loader tail), a ``print_freq`` row inside a chunk, the
  telemetry span of a chunk (``steps``, the summed gossip rounds), a
  preemption acted on after the chunk, ``bilat_async``'s publish and
  adoption once a chunk at its last step, and the reference's prefetch
  warning, once.
* ``--stem_s2d True`` trains a ResNet through the command line.
"""

import csv
import json
import logging
import os
import sys

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
from stochastic_gradient_push_torch.run import gossip_sgd
from stochastic_gradient_push_torch.train import loop as tloop
from stochastic_gradient_push_torch.train.step import make_model
from stochastic_gradient_push_torch.utils.checkpoint import (
    CheckpointManager, ClusterManager)
from torch_launch import torchrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, CLASSES, IMG = 4, 4, 4, 8
BATCHES = 11          # a loader's batches an epoch
PARAM_ATOL = 2e-6
TIMING = slice(2, 11)   # BT, NT, DT: value, mean, std each
ALGS = {"sgp": dict(), "osgp": dict(overlap=True, staleness=2)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(cls, topo, path, alg, scan, cap=None, ignore=1, epochs=2, **kw):
    return cls(graph_class=topo.NPeerDynamicDirectedExponentialGraph,
               lr=0.2, warmup=False, lr_schedule={1: 0.5}, batch_size=BATCH,
               num_epochs=epochs, num_itr_ignore=ignore, print_freq=3,
               checkpoint_dir=str(path), num_classes=CLASSES, verbose=False,
               num_iterations_per_training_epoch=cap, scan_steps=scan,
               **ALGS[alg], **kw)


def _loader(seed=0):
    images, labels = synthetic_classification(
        WORLD * BATCH * BATCHES, num_classes=CLASSES, image_size=IMG,
        seed=seed)
    sampler = DistributedSampler(len(images), WORLD)
    return ShardedLoader(images, labels, BATCH, sampler), sampler


def _trainer(path, alg, scan, **kw):
    cluster = ClusterManager(CheckpointManager(
        str(path), world_size=WORLD, ranks=range(WORLD)),
        install_handlers=False)
    model = make_model("tiny_mlp", num_classes=CLASSES,
                       in_features=3 * IMG * IMG)
    return model, tloop.Trainer(_cfg(tloop.TrainerConfig, ttopo, path, alg,
                                     scan, **kw), model,
                                StackedTransport(WORLD),
                                cluster_manager=cluster, device="cpu")


def _csv(path, world=WORLD):
    with open(os.path.join(path, f"out_r0_n{world}.csv")) as f:
        rows = list(csv.reader(f))
    return rows[:5], [r[:TIMING.start] + r[TIMING.stop:] for r in rows[5:]]


def _chunks(trainer):
    """Record the chunk size of every device copy of a batch."""
    sizes = []
    real = trainer._on_device

    def spy(a):
        out = real(a)
        if out.dtype.is_floating_point:
            sizes.append(out.shape[0] if out.dim() == 6 else 1)
        return out

    trainer._on_device = spy
    return sizes


def _fit(path, alg, scan, start=None, **kw):
    model, trainer = _trainer(path, alg, scan, **kw)
    sizes = _chunks(trainer)
    loader, sampler = _loader()
    state = trainer.init_state() if start is None else \
        train_state_from_jax(start, model=model)
    state, _ = trainer.fit(state, loader, sampler)
    return state, sizes


def _assert_equal_states(a, b):
    assert a.step == b.step and a.gossip.phase == b.gossip.phase
    assert torch.equal(a.gossip.ps_weight, b.gossip.ps_weight)
    for tree in ("params", "opt_state", "batch_stats"):
        for n, t in getattr(b, tree).items():
            assert torch.equal(getattr(a, tree)[n], t), (tree, n)
    assert len(a.gossip.in_flight) == len(b.gossip.in_flight)
    for (ap, aw), (bp, bw) in zip(a.gossip.in_flight, b.gossip.in_flight):
        assert torch.equal(aw, bw)
        assert all(torch.equal(ap[n], t) for n, t in bp.items())


# an epoch at cap None: the loader's 11 batches, so 1 warm-up single
# (the warm-up window restarts each epoch, as the reference's), chunks
# of 4 and 4, and a loader tail of 2 singles; at cap 10 a cap tail of 1
CHUNKS = {None: [1, 4, 4, 1, 1] * 2, 10: [1, 4, 4, 1] * 2}


def _row_itrs(n: int, freq: int, val: bool = False) -> list:
    """The ``itr`` column of an epoch's rows: the 0-based steps that are
    multiples of ``print_freq``, the epoch's closing row, the validation
    row (-1)."""
    return [i for i in range(n) if i % freq == 0] + [n - 1] + (
        [-1] if val else [])


@pytest.mark.parametrize("cap", [None, 10])
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_scan_steps_4_is_scan_steps_1_bit_for_bit(tmp_path, alg, cap):
    one, sizes_one = _fit(tmp_path / "one", alg, 1, cap=cap)
    four, sizes_four = _fit(tmp_path / "four", alg, 4, cap=cap)
    assert sizes_one == [1] * sum(CHUNKS[cap])
    assert sizes_four == CHUNKS[cap]
    _assert_equal_states(four, one)
    assert _csv(tmp_path / "four") == _csv(tmp_path / "one")
    # print_freq 3 rows fall inside chunks (steps 3, 6 and 9 of each
    # epoch), beside each epoch's closing row
    itrs = [int(r[1]) for r in _csv(tmp_path / "four")[1] if r[1]]
    assert itrs == _row_itrs(cap or BATCHES, 3, True) * 2


def _reference_fit(path, alg, scan):
    from stochastic_gradient_push_tpu import topology as jtopo
    from stochastic_gradient_push_tpu.models import TinyMLP
    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh
    from stochastic_gradient_push_tpu.train.loop import (
        Trainer, TrainerConfig)
    from stochastic_gradient_push_tpu.utils.checkpoint import (
        CheckpointManager as JCkpt, ClusterManager as JCluster)

    cluster = JCluster(JCkpt(str(path), world_size=WORLD),
                       install_handlers=False)
    trainer = Trainer(_cfg(TrainerConfig, jtopo, path, alg, scan),
                      TinyMLP(num_classes=CLASSES), make_gossip_mesh(WORLD),
                      sample_input_shape=(BATCH, IMG, IMG, 3),
                      cluster_manager=cluster)
    state = trainer.init_state()
    start = jax.device_get(state)
    loader, sampler = _loader()
    state, _ = trainer.fit(state, loader, sampler)
    return start, jax.device_get(state)


@pytest.mark.parametrize("alg", sorted(ALGS))
def test_scanned_run_matches_the_references(tmp_path, alg):
    start, want_np = _reference_fit(tmp_path / "ref", alg, 4)
    got, sizes = _fit(tmp_path / "port", alg, 4, start=start)
    assert sizes == CHUNKS[None]
    model = make_model("tiny_mlp", num_classes=CLASSES,
                       in_features=3 * IMG * IMG)
    want = train_state_from_jax(want_np, model=model)
    assert got.step == want.step == 2 * BATCHES
    assert got.gossip.phase == want.gossip.phase
    assert torch.equal(got.gossip.ps_weight, want.gossip.ps_weight)
    for tree in ("params", "opt_state"):
        for n, w in getattr(want, tree).items():
            torch.testing.assert_close(getattr(got, tree)[n], w, rtol=0,
                                       atol=PARAM_ATOL)
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        assert torch.equal(gw, ww)
        for n in wp:
            torch.testing.assert_close(gp[n], wp[n], rtol=0,
                                       atol=PARAM_ATOL)
    assert _csv(tmp_path / "port") == _csv(tmp_path / "ref")


# -- chunk boundaries --------------------------------------------------------


@pytest.mark.parametrize("ignore,cap,want", [
    (3, None, [1, 1, 1, 4, 4] * 2),     # a long warm-up
    (0, 9, [4, 4, 1] * 2),              # a cap tail of 1
    (0, 6, [4, 1, 1] * 2),              # a cap tail of 2
    (0, None, [4, 4, 1, 1, 1] * 2),     # a loader tail of 3
])
def test_chunk_sizes_follow_the_references_rules(tmp_path, ignore, cap,
                                                 want):
    _, trainer = _trainer(tmp_path, "sgp", 4, cap=cap, ignore=ignore)
    sizes = _chunks(trainer)
    loader, sampler = _loader()
    trainer.fit(trainer.init_state(), loader, sampler)
    assert sizes == want


def test_a_chunks_span_counts_its_steps_and_rounds(tmp_path):
    _, trainer = _trainer(tmp_path / "c", "sgp", 4, cap=9, ignore=1,
                          epochs=1, trace_dir=str(tmp_path / "t"),
                          metrics_every=2)
    loader, sampler = _loader()
    trainer.fit(trainer.init_state(), loader, sampler)
    with open(tmp_path / "t" / "trace.json") as f:
        trace = json.load(f)
    spans = [e["args"] for e in trace["traceEvents"]
             if e.get("name") == "train_step"]
    assert [s["steps"] for s in spans] == [1, 4, 4]
    # SGP gossips every step
    assert [s["gossip"] for s in spans] == [1, 4, 4]
    with open(tmp_path / "t" / "events.jsonl") as f:
        stats = [json.loads(line) for line in f]
    # step_stats where a chunk holds a multiple of metrics_every: steps
    # 1 (no), 2-5 and 6-9, each at the chunk's last step
    assert [e["step"] for e in stats if e["kind"] == "step_stats"] == [5, 9]


def test_prefetch_with_scan_steps_warns_once_and_runs_without(tmp_path,
                                                              caplog):
    _, trainer = _trainer(tmp_path, "sgp", 4, cap=5, prefetch=True)
    sizes = _chunks(trainer)
    loader, sampler = _loader()
    trainer.log.propagate = True
    with caplog.at_level(logging.WARNING):
        trainer.fit(trainer.init_state(), loader, sampler)
    warned = [r for r in caplog.records
              if "prefetch supports single-process non-scanned runs only"
              in r.getMessage()]
    assert len(warned) == 1
    assert sizes == [1, 4, 1, 4]


def test_a_preemption_is_acted_on_after_the_chunk(tmp_path):
    model, trainer = _trainer(tmp_path, "sgp", 4, cap=None, ignore=1)
    calls, signalled = [], []
    real = trainer._train_fn

    def train_fn(ppi, itr_per_epoch):
        alg, step = real(ppi, itr_per_epoch)

        def counted(state, x, y):
            calls.append(1)
            if len(calls) == 3:       # inside the first chunk of 4
                signalled.append(True)
            return step(state, x, y)

        return alg, counted

    trainer._train_fn = train_fn
    trainer.cluster.any_rank_signalled = lambda: bool(signalled)
    loader, sampler = _loader()
    with pytest.raises(SystemExit) as e:
        trainer.fit(trainer.init_state(), loader, sampler)
    assert e.value.code == 75
    # the single warm-up step and the whole chunk ran
    assert len(calls) == 5
    meta = json.loads(torch.load(tmp_path / f"checkpoint_r0_n{WORLD}.ckpt",
                                 weights_only=False)["meta"])
    assert meta["itr"] == 5


# -- the command line ---------------------------------------------------------

BASE = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
        "--image_size", "16", "--num_classes", "10", "--batch_size", "4",
        "--num_epochs", "1", "--num_iterations_per_training_epoch", "7",
        "--num_itr_ignore", "1", "--print_freq", "2", "--verbose", "False"]
CLI_ALGS = {"sgp": [], "osgp": ["--overlap", "True", "--staleness", "2"]}


def _rank_files(path, world):
    return [torch.load(os.path.join(path, f"checkpoint_r{r}_n{world}.ckpt"),
                       weights_only=False)["state"] for r in range(world)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if dataclasses_like(tree):
        return _flat(vars(tree), prefix)
    return {prefix: torch.as_tensor(tree)}


def dataclasses_like(x) -> bool:
    return hasattr(x, "__dataclass_fields__")


def _assert_same_files(a, b, world):
    for fa, fb in zip(_rank_files(a, world), _rank_files(b, world)):
        ta, tb = _flat(fa), _flat(fb)
        assert set(ta) == set(tb)
        for k in tb:
            assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("alg", sorted(CLI_ALGS))
def test_cli_scan_steps_is_scan_steps_1(tmp_path, alg):
    runs = {}
    for scan in (1, 3):
        d = tmp_path / str(scan)
        gossip_sgd.main(BASE + CLI_ALGS[alg] + [
            "--world_size", "2", "--scan_steps", str(scan),
            "--checkpoint_dir", str(d)])
        runs[scan] = _csv(d, 2)
    assert runs[3] == runs[1]
    assert [int(r[1]) for r in runs[3][1] if r[1]] == _row_itrs(7, 2, True)
    _assert_same_files(tmp_path / "3", tmp_path / "1", 2)


def test_cli_stem_s2d_trains_a_resnet(tmp_path):
    argv = BASE[:4] + ["--model", "resnet18"] + BASE[6:] + [
        "--world_size", "2", "--num_iterations_per_training_epoch", "2",
        "--stem_s2d", "True", "--checkpoint_dir", str(tmp_path)]
    gossip_sgd.main(argv)
    state = _rank_files(tmp_path, 2)[0]
    assert tuple(state["params"]["conv1.weight"].shape) == (64, 12, 4, 4)
    rows = _csv(tmp_path, 2)[1]
    assert rows and all(np.isfinite(float(r[2])) for r in rows if r[1])


_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import json
import torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.parallel import multihost
from stochastic_gradient_push_torch.run import gossip_sgd

multihost.initialize_multihost("gloo", "cpu")
gossip_sgd.main(json.loads(sys.argv[2]))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def test_under_torchrun_each_process_stacks_its_own_rows(tmp_path):
    argv = BASE + CLI_ALGS["osgp"] + ["--scan_steps", "3"]
    logs = torchrun(2, lambda r: [
        sys.executable, "-c", _CHILD, REPO,
        json.dumps(argv + ["--checkpoint_dir", str(tmp_path / "dist")])],
        PYTHONPATH=REPO)
    assert all("Traceback" not in log for log in logs), logs
    gossip_sgd.main(argv[:] + ["--world_size", "2", "--scan_steps", "1",
                               "--checkpoint_dir", str(tmp_path / "one")])
    assert _csv(tmp_path / "dist", 2) == _csv(tmp_path / "one", 2)
    _assert_same_files(tmp_path / "dist", tmp_path / "one", 2)


def test_bilat_async_publishes_and_adopts_once_a_chunk(tmp_path,
                                                       monkeypatch):
    """``bilat_async`` hands the averaging thread the params once a
    chunk, at the chunk's last global step, as the reference does."""
    from stochastic_gradient_push_torch.train import async_bilat

    seen = {"publish": [], "adopt": []}
    for name, key in (("publish", "publish"), ("maybe_adopt", "adopt")):
        real = getattr(async_bilat.AsyncBilateralAverager, name)

        def spy(self, step, params, real=real, key=key):
            seen[key].append(step)
            return real(self, step, params)

        monkeypatch.setattr(async_bilat.AsyncBilateralAverager, name, spy)
    cluster = ClusterManager(CheckpointManager(
        str(tmp_path), world_size=WORLD, ranks=range(WORLD)),
        install_handlers=False)
    model = make_model("tiny_mlp", num_classes=CLASSES,
                       in_features=3 * IMG * IMG)
    cfg = tloop.TrainerConfig(
        graph_class=ttopo.DynamicBipartiteExponentialGraph, bilat=True,
        bilat_async=True, lr=0.2, warmup=False, batch_size=BATCH,
        num_epochs=1, num_itr_ignore=1, print_freq=3,
        checkpoint_dir=str(tmp_path), num_classes=CLASSES, verbose=False,
        num_iterations_per_training_epoch=10, scan_steps=4)
    trainer = tloop.Trainer(cfg, model, StackedTransport(WORLD),
                            cluster_manager=cluster, device="cpu")
    sizes = _chunks(trainer)
    loader, sampler = _loader()
    trainer.fit(trainer.init_state(), loader, sampler)
    assert sizes == CHUNKS[10][:4]
    # chunks [1, 4, 4, 1] over the 0-based ticks 0, 1-4, 5-8, 9
    assert seen["publish"] == seen["adopt"] == [0, 4, 8, 9]
