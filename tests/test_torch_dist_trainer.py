"""One rank per process: the Trainer and the image CLIs
(``run/gossip_sgd.py``, ``run/gossip_sgd_adpsgd.py``) under a torchrun
environment, over gloo on the CPU, against the stacked lane, and the
launch helpers (``parallel/discovery.py``, ``parallel/multihost.py``).

* World 2 and 4: the five algorithms (AllReduce, SGP, OSGP at staleness
  2, D-PSGD, synchronous AD-PSGD), 3 steps of ``tiny_cnn``.  Every
  process's checkpoint file equals the stacked run's file for its rank:
  parameters, momentum, BatchNorm statistics, ps-weight, step and phase
  bit-equal (each rank runs the same per-rank ops on the same batch
  rows; AllReduce at world 4 is held to 1e-6, since gloo's ring sums
  the four gradients in another order than the stacked ``sum(0)``), and
  rank 0's CSV equals the stacked CSV outside its timing columns.
* Resume across the lanes: a run resumed by the other lane from one
  epoch's rank files equals the straight two-epoch stacked run, both
  ways (OSGP, so the drained FIFO rides the files).
* SIGUSR1 to one process makes every process save at one step and exit
  75.
* ``discover`` reads torchrun's and SLURM's variables; an unset
  ``--device`` under torchrun resolves to ``cuda:{LOCAL_RANK % cards}``
  where a card is present; ``--backend xla`` is gloo where ranks share
  a card; ``consensus_resume_point`` agrees on the least point.

Each child process runs under its own ``communicate(timeout=...)`` with
one torch thread.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import discovery, multihost
from stochastic_gradient_push_torch.run import gossip_sgd, gossip_sgd_adpsgd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
        "--image_size", "16", "--num_classes", "10", "--batch_size", "8",
        "--num_iterations_per_training_epoch", "3", "--num_itr_ignore", "0",
        "--print_freq", "1", "--verbose", "False"]
ALGORITHMS = {
    "ar": ("gossip_sgd", ["--all_reduce", "True", "--graph_type", "-1"]),
    "sgp": ("gossip_sgd", []),
    "osgp": ("gossip_sgd", ["--overlap", "True", "--staleness", "2"]),
    "dpsgd": ("gossip_sgd", ["--push_sum", "False"]),
    "adpsgd": ("gossip_sgd_adpsgd", []),
}
# AllReduce at world 4: gloo's ring sums the gradients in another order
AR_ATOL = 1e-6
# CSV columns 2-10 are the host-clock meters
TIMING = slice(2, 11)

_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from stochastic_gradient_push_torch.parallel import collectives, multihost
from stochastic_gradient_push_torch.run import gossip_sgd, gossip_sgd_adpsgd

multihost.initialize_multihost("gloo", "cpu")
rank = torch.distributed.get_rank()
# a torn save window: every process resumes from the least point
point = multihost.consensus_resume_point(3 - rank, 7 + rank,
                                         collectives.DistTransport())
print("consensus " + json.dumps(point), flush=True)
for module, argv in json.loads(sys.argv[2]):
    mod = gossip_sgd_adpsgd if module == "gossip_sgd_adpsgd" else gossip_sgd
    mod.main(argv)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, world, port):
    """A torchrun environment for ``rank`` of ``world`` on this host."""
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


def _launch(world, runs, timeout=300):
    """Every ``(module, argv)`` of ``runs`` in turn, in ``world``
    processes of one gloo group; returns the processes' logs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, REPO, json.dumps(runs)],
        env=_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    return logs


def _stacked(module, argv):
    mod = gossip_sgd_adpsgd if module == "gossip_sgd_adpsgd" else gossip_sgd
    mod.main(argv)


def _rank_file(directory, r, world):
    return torch.load(os.path.join(directory, f"checkpoint_r{r}_n{world}.ckpt"),
                      weights_only=True)


def _tensors(tree, prefix=""):
    """``{path: tensor}`` of a rank file's state (FIFO slots included)."""
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


def _csv_rows(directory, world):
    with open(os.path.join(directory, f"out_r0_n{world}.csv")) as f:
        rows = [line.strip().split(",") for line in f]
    return [r[:TIMING.start] + r[TIMING.stop:] if len(r) > 11 else r
            for r in rows]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def lanes(request, tmp_path_factory):
    """Every algorithm at one world, one rank per process and stacked:
    ``(world, root, logs)``; ``root/<alg>/{dist,stacked}`` hold the
    runs."""
    world = request.param
    root = tmp_path_factory.mktemp(f"lanes{world}")
    runs = [(module, BASE + extra + ["--num_epochs", "1", "--checkpoint_dir",
                                     str(root / alg / "dist")])
            for alg, (module, extra) in ALGORITHMS.items()]
    logs = _launch(world, runs)
    for alg, (module, extra) in ALGORITHMS.items():
        _stacked(module, BASE + extra + [
            "--num_epochs", "1", "--world_size", str(world),
            "--checkpoint_dir", str(root / alg / "stacked")])
    return world, root, logs


@pytest.mark.parametrize("alg", sorted(ALGORITHMS))
def test_rank_files_equal_the_stacked_lanes(lanes, alg):
    world, root, _ = lanes
    atol = AR_ATOL if alg == "ar" and world > 2 else 0.0
    for r in range(world):
        got = _rank_file(root / alg / "dist", r, world)
        want = _rank_file(root / alg / "stacked", r, world)
        assert set(json.loads(got["meta"])) == set(json.loads(want["meta"]))
        g, w = _tensors(got["state"]), _tensors(want["state"])
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=atol,
                                       msg=f"rank {r} {k}")
        assert "/gossip/ps_weight" in w
        assert any(k.startswith("/opt_state/") for k in w)


@pytest.mark.parametrize("alg", sorted(ALGORITHMS))
def test_rank0_csv_holds_every_ranks_metrics(lanes, alg):
    world, root, _ = lanes
    got = _csv_rows(root / alg / "dist", world)
    want = _csv_rows(root / alg / "stacked", world)
    if alg == "ar" and world > 2:
        got, want = got[:5], want[:5]   # the header block
    assert got == want
    assert not os.path.exists(root / alg / "dist" / f"out_r1_n{world}.csv")


def test_processes_agree_on_the_least_resume_point(lanes):
    world, _, logs = lanes
    for log in logs:
        line = next(x for x in log.splitlines() if x.startswith("consensus"))
        assert json.loads(line.split(" ", 1)[1]) == [4 - world, 6 + world]


def test_resume_equals_continue_across_the_two_lanes(tmp_path):
    osgp = BASE + ALGORITHMS["osgp"][1]
    # the straight two-epoch stacked run
    _stacked("gossip_sgd", osgp + ["--num_epochs", "2", "--world_size", "2",
                                   "--checkpoint_dir", str(tmp_path / "s")])
    # one stacked epoch, to be resumed one rank per process
    _stacked("gossip_sgd", osgp + ["--num_epochs", "1", "--world_size", "2",
                                   "--checkpoint_dir", str(tmp_path / "a")])
    _launch(2, [
        ("gossip_sgd", osgp + ["--num_epochs", "2", "--resume", "True",
                               "--checkpoint_dir", str(tmp_path / "a")]),
        # one epoch one rank per process, to be resumed stacked
        ("gossip_sgd", osgp + ["--num_epochs", "1",
                               "--checkpoint_dir", str(tmp_path / "b")])])
    _stacked("gossip_sgd", osgp + ["--num_epochs", "2", "--resume", "True",
                                   "--world_size", "2",
                                   "--checkpoint_dir", str(tmp_path / "b")])
    for r in range(2):
        want = _tensors(_rank_file(tmp_path / "s", r, 2)["state"])
        for lane in ("a", "b"):
            got = _tensors(_rank_file(tmp_path / lane, r, 2)["state"])
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (lane, r, k)


def test_sigusr1_to_one_process_makes_every_process_exit_75(tmp_path):
    port = _free_port()
    argv = BASE + ["--num_epochs", "50", "--checkpoint_dir", str(tmp_path)]
    argv[argv.index("--num_iterations_per_training_epoch") + 1] = "400"
    argv += ["--synthetic_samples", "8000", "--image_size", "8"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run."
         "gossip_sgd", *argv], env=_env(r, 2, port), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    csv = tmp_path / "out_r0_n2.csv"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if csv.exists() and len(csv.read_text().splitlines()) >= 7:
                break
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGUSR1)
        logs = [p.communicate(timeout=120)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [75, 75], "\n".join(logs)
    files = [_rank_file(tmp_path, r, 2) for r in range(2)]
    metas = [json.loads(f["meta"]) for f in files]
    assert metas[0]["itr"] == metas[1]["itr"] > 0
    assert metas[0]["epoch"] == metas[1]["epoch"] == 0
    assert files[0]["state"]["step"] == files[1]["state"]["step"] \
        == metas[0]["itr"]


# -- the launch helpers ------------------------------------------------------


def test_discover_reads_torchrun_slurm_and_a_single_process():
    info = discovery.discover({"RANK": "3", "WORLD_SIZE": "4",
                               "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
                               "MASTER_ADDR": "h0", "MASTER_PORT": "29500"})
    assert (info.launcher, info.rank, info.world_size, info.local_rank,
            info.local_world_size) == ("torchrun", 3, 4, 1, 2)
    assert info.init_method == "tcp://h0:29500" and info.is_multiprocess
    info = discovery.discover({"SLURM_PROCID": "5", "SLURM_NTASKS": "8",
                               "SLURM_LOCALID": "1",
                               "SLURM_NTASKS_PER_NODE": "4(x2)",
                               "SLURM_JOB_NODELIST": "gpu-[003-004,010]"})
    assert (info.launcher, info.rank, info.world_size, info.local_rank,
            info.local_world_size) == ("slurm", 5, 8, 1, 4)
    assert info.init_method == "tcp://gpu-003:40100"
    info = discovery.discover({})
    assert (info.launcher, info.world_size) == ("single", 1)
    assert not info.is_multiprocess


def test_unset_device_under_torchrun_resolves_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    info = discovery.discover({"RANK": "3", "WORLD_SIZE": "4",
                               "LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"})
    assert multihost.process_device(None, info) == torch.device("cuda", 1)
    assert multihost.process_device("cuda", info) == torch.device("cuda", 1)
    assert multihost.process_device("cpu", info) == torch.device("cpu")
    # four ranks on two cards share them: NCCL would refuse, xla is gloo
    cuda = torch.device("cuda", 1)
    assert multihost.resolve_backend("xla", cuda, info) == "gloo"
    two = discovery.discover({"RANK": "1", "WORLD_SIZE": "2",
                              "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"})
    assert multihost.resolve_backend("xla", cuda, two) == "nccl"
    assert multihost.resolve_backend("gloo", cuda, two) == "gloo"


def test_backend_flag_is_checked():
    cpu = torch.device("cpu")
    assert multihost.resolve_backend("xla", cpu) == "gloo"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        multihost.resolve_backend("nccl", cpu)
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.resolve_backend("tcp", cpu)


def test_host_views_of_a_stacked_world_are_the_world():
    transport = tc.StackedTransport(3)
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(multihost.to_host(x, transport), x.numpy())
    rows = multihost.host_local_slice({"a": x.numpy(), "b": x}, transport)
    np.testing.assert_array_equal(rows["a"], x.numpy())
    assert torch.equal(rows["b"], x)
    assert multihost.consensus_resume_point(2, 5, transport) == (2, 5)


def test_world_size_flag_must_match_the_launcher(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--world_size 4 but the launcher "
                                         "started 2"):
        gossip_sgd.main(BASE + ["--world_size", "4", "--checkpoint_dir",
                                str(tmp_path)])
