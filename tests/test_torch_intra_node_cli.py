"""``--nprocs_per_node`` through the image CLI (``run/gossip_sgd.py``) on
the CPU, stacked and under a torchrun environment over gloo.

* Stacked, ``--world_size 8 --nprocs_per_node 2`` (4 nodes of 2 devices),
  ``tiny_cnn`` with BatchNorm, 8 px, 4 images a device row, per-rank
  CSVs, one epoch of three steps: the files ``out_r{0..3}_n8.csv`` (the
  CSV's ``World-Size`` 8) and ``checkpoint_r{0..3}_n8.ckpt``, one per
  node; each node's CSV losses equal, to the CSV's four decimals, to the
  port's step driven by hand on the same data, init and LR (at an LR
  where the LR's world shows: 8 devices, not 4 nodes; the step itself is held to the reference in ``tests/test_torch_intra_node.py``).
* ``--resume True`` equals continuing, bit for bit, and
  ``--gossip_kernel pallas`` off CUDA raises as on the flat lane.
* Refusals naming the flags: a world that ``--nprocs_per_node`` does
  not divide (the reference's message), and under torchrun a
  ``--world_size`` other than processes × ``--nprocs_per_node``.
* Under torchrun, 2 processes × ``--nprocs_per_node 2`` (world 4
  devices, 2 nodes), SGP and AllReduce: each process logs the batch
  rows it feeds (``[0, 1]`` and ``[2, 3]``), and the per-rank CSVs
  (outside their timing columns) and the rank files equal the stacked
  ``--world_size 4 --nprocs_per_node 2`` run's, bit for bit (each
  process runs the same per-row ops on the same rows, and a two-node
  sum is exact).  Children are joined with timeouts, one torch thread
  each, and the stacked runs are pinned to one thread.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.data.pipeline import (
    DistributedSampler, ShardedLoader)
from stochastic_gradient_push_torch.data.synthetic import (
    synthetic_classification)
from stochastic_gradient_push_torch.ops.gossip_kernel import (
    KernelBackendError)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.run import gossip_sgd
from stochastic_gradient_push_torch.topology import build_schedule
from stochastic_gradient_push_torch.algorithms import sgp
from stochastic_gradient_push_torch.train import step as tstep
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
from torch_launch import torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LOCAL, B, IMG, C, ITRS = 8, 2, 4, 8, 10, 3
NODES = WORLD // LOCAL
BASE = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
        "--image_size", str(IMG), "--num_classes", str(C), "--batch_size",
        str(B), "--num_iterations_per_training_epoch", str(ITRS),
        "--num_itr_ignore", "0", "--print_freq", "1", "--per_rank_csv",
        "True", "--nprocs_per_node", str(LOCAL)]
# an LR large enough that its world (devices, not nodes) shows in the
# losses after the first step
ARGV = BASE + ["--world_size", str(WORLD), "--verbose", "False", "--lr",
               "3.2"]
TIMING = slice(2, 11)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _rank_file(directory, r, world):
    return torch.load(os.path.join(directory, f"checkpoint_r{r}_n{world}"
                                              ".ckpt"), weights_only=True)


def _tensors(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_tensors(v, f"{prefix}/{i}"))
    else:
        out[prefix] = torch.as_tensor(tree)
    return out


def _assert_rank_files_equal(a, b, nodes, world):
    for r in range(nodes):
        got, want = (_tensors(_rank_file(d, r, world)["state"])
                     for d in (a, b))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


def _by_hand():
    """Each node's loss a step: the CLI's data, init and LR, through
    the port's step at ``local_axis=2``."""
    cfg, _ = gossip_sgd.parse_config(ARGV)
    n = WORLD * B * 8
    images, labels = synthetic_classification(
        n + max(WORLD * B, n // 8), num_classes=C, image_size=IMG,
        seed=cfg.seed)
    sampler = DistributedSampler(n, WORLD)
    loader = ShardedLoader(images[:n], labels[:n], B, sampler)
    sampler.set_epoch(cfg.seed * 90)
    model = tstep.make_model("tiny_cnn", num_classes=C)
    alg = sgp(build_schedule(cfg.graph_class(NODES, peers_per_itr=1),
                             cfg.mixing_class()), StackedTransport(NODES))
    tx = sgd(momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    step = tstep.build_train_step(
        model, alg, tx, LRSchedule(cfg.lr, B, WORLD, cfg.lr_schedule),
        ITRS, C, local_axis=LOCAL)
    state = tstep.init_train_state(model, alg, tx, NODES, seed=cfg.seed)
    losses = []
    for _, (x, y) in zip(range(ITRS), loader):
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(m["loss"].tolist())
    return losses


def test_stacked_cli_writes_node_files_named_by_the_device_world(tmp_path):
    gossip_sgd.main(ARGV + ["--num_epochs", "1", "--checkpoint_dir",
                            str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("out_")] == [
        f"out_r{r}_n{WORLD}.csv" for r in range(NODES)]
    assert [n for n in names if n.startswith("checkpoint_")] == [
        f"checkpoint_r{r}_n{WORLD}.ckpt" for r in range(NODES)]
    losses = _by_hand()
    for r in range(NODES):
        rows = _csv_rows(tmp_path / f"out_r{r}_n{WORLD}.csv")
        assert rows[1] == ["World-Size", str(WORLD)]
        body = rows[5:]
        assert [row[:2] for row in body] == [["0", "0"], ["0", "1"],
                                             ["0", "2"], ["0", "2"],
                                             ["0", "-1"]]
        assert [row[11] for row in body[:ITRS]] == [
            f"{step[r]:.4f}" for step in losses]
        assert _rank_file(tmp_path, r, WORLD)["state"]["step"] == ITRS


def test_resume_equals_continue(tmp_path):
    argv = ARGV + ["--overlap", "True", "--staleness", "2"]
    gossip_sgd.main(argv + ["--num_epochs", "2", "--checkpoint_dir",
                            str(tmp_path / "a")])
    gossip_sgd.main(argv + ["--num_epochs", "1", "--checkpoint_dir",
                            str(tmp_path / "b")])
    gossip_sgd.main(argv + ["--num_epochs", "2", "--resume", "True",
                            "--checkpoint_dir", str(tmp_path / "b")])
    _assert_rank_files_equal(tmp_path / "a", tmp_path / "b", NODES, WORLD)
    for r in range(NODES):
        a, b = (_csv_rows(tmp_path / d / f"out_r{r}_n{WORLD}.csv")
                for d in ("a", "b"))
        assert [x[:2] + x[11:] for x in a[5:]] == [x[:2] + x[11:]
                                                   for x in b[5:]]


def test_pallas_off_cuda_raises(tmp_path):
    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas"):
        gossip_sgd.main(ARGV + ["--num_epochs", "1", "--gossip_kernel",
                                "pallas", "--checkpoint_dir", str(tmp_path)])


@pytest.mark.parametrize("world,local", [(6, 4), (8, 3), (1, 2)])
def test_indivisible_world_is_refused_naming_the_flags(tmp_path, world,
                                                       local):
    with pytest.raises(SystemExit,
                       match=f"--world_size {world} --nprocs_per_node "
                             f"{local}: {world} devices not divisible by "
                             f"nprocs_per_node={local}"):
        gossip_sgd.main(BASE + ["--world_size", str(world),
                                "--nprocs_per_node", str(local),
                                "--checkpoint_dir", str(tmp_path)])


def test_world_size_under_torchrun_counts_processes_times_local(
        monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--world_size 6 but the launcher "
                                         "started 2 processes of "
                                         "--nprocs_per_node 2 devices each "
                                         r"\(4\)"):
        gossip_sgd.main(BASE + ["--world_size", "6", "--checkpoint_dir",
                                str(tmp_path)])


# -- under torchrun -----------------------------------------------------------

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.parallel import multihost
from stochastic_gradient_push_torch.run import gossip_sgd
# one group for both runs: the rendezvous store outlives a group
multihost.initialize_multihost("gloo", "cpu")
for argv in json.loads(sys.argv[2]):
    gossip_sgd.main(argv)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""
DIST = BASE + ["--num_epochs", "1", "--verbose", "True"]
DIST_ALGS = {"sgp": [],
             "ar": ["--all_reduce", "True", "--graph_type", "-1"]}


def _launch(procs_n, runs, timeout=300):
    return torchrun(procs_n, lambda r: [sys.executable, "-c", _CHILD, REPO,
                                        json.dumps(runs)], timeout=timeout,
                    PYTHONPATH=REPO)


@pytest.fixture(scope="module")
def torchrun_runs(tmp_path_factory):
    """2 processes × ``--nprocs_per_node 2`` and the stacked ``--world_size
    4`` runs of each algorithm: ``(root, logs)``."""
    root = tmp_path_factory.mktemp("intra_node_dist")
    logs = _launch(2, [DIST + extra + ["--checkpoint_dir",
                                       str(root / alg / "dist")]
                       for alg, extra in DIST_ALGS.items()])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for alg, extra in DIST_ALGS.items():
            gossip_sgd.main(DIST + extra + [
                "--world_size", "4", "--checkpoint_dir",
                str(root / alg / "stacked")])
    finally:
        torch.set_num_threads(threads)
    return root, logs


def test_each_process_feeds_its_nodes_rows(torchrun_runs):
    _, logs = torchrun_runs
    for p, log in enumerate(logs):
        rows = [p * LOCAL + l for l in range(LOCAL)]
        assert f"process {p}/2: feeding batch rows {rows}" in log, log
        assert "2 nodes x 2 devices" in log


@pytest.mark.parametrize("alg", sorted(DIST_ALGS))
def test_processes_equal_the_stacked_run(torchrun_runs, alg):
    root, _ = torchrun_runs
    _assert_rank_files_equal(root / alg / "dist", root / alg / "stacked", 2,
                             4)
    for r in range(2):
        got, want = (_csv_rows(root / alg / lane / f"out_r{r}_n4.csv")
                     for lane in ("dist", "stacked"))
        assert got[:5] == want[:5] and got[1] == ["World-Size", "4"]
        strip = lambda rows: [x[:TIMING.start] + x[TIMING.stop:]
                              for x in rows[5:]]
        assert strip(got) == strip(want)
        assert len(got) == 5 + ITRS + 2
    assert np.isfinite(float(_csv_rows(root / alg / "dist" /
                                       "out_r0_n4.csv")[5][11]))
