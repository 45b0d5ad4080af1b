"""Port parity: the reference's flag form of a multi-host launch, its
launcher variables, and the deprecated ``--gossip_comm_dtype`` alias.

* ``discover`` on the flags, on SLURM's and on OpenMPI's variables gives
  the ``(coordinator, num_processes, process_id)`` that the reference's
  ``initialize_multihost`` hands ``jax.distributed.initialize``
  (monkeypatched, as the reference's ``tests/test_utils.py:92-114``
  does), and refuses the multi-node OpenMPI launch it refuses;
  ``multihost_env`` is the reference's ``_multihost_env``;
* a second default group on one held store joins (the keys of each join
  apart), where it once hung;
* 2 gloo processes launched with ``--multihost True --coordinator_address
  ... --num_processes 2 --process_id i`` and no torchrun variables are
  bit-equal to the same run under the torchrun environment, for
  ``run/gossip_sgd.py`` and ``run/gossip_lm.py``;
* ``--gossip_comm_dtype bf16`` gives ``--wire_dtype bf16``'s config and
  first step, with the reference's warning.
"""

import csv
import os
import sys
import types
from pathlib import Path

import pytest
import torch

from stochastic_gradient_push_torch.parallel import discovery
from stochastic_gradient_push_torch.run import gossip_lm, gossip_sgd

sys.path.insert(0, str(Path(__file__).parent))
from torch_launch import Rendezvous, join, torchrun  # noqa: E402

REPO = str(Path(__file__).resolve().parents[1])
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
               "SLURM_LOCALID", "SLURM_JOB_NODELIST", "SLURM_NTASKS_PER_NODE",
               "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_UNIVERSE_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "COORDINATOR_ADDRESS",
               "COORDINATOR_PORT", "JAX_COORDINATOR_ADDRESS",
               "TPU_WORKER_HOSTNAMES", "HOSTNAME")


def _flags(multihost="True", coordinator_address=None, num_processes=None,
           process_id=None):
    return types.SimpleNamespace(multihost=multihost,
                                 coordinator_address=coordinator_address,
                                 num_processes=num_processes,
                                 process_id=process_id)


@pytest.fixture
def launch_env(monkeypatch):
    """A clean launcher environment to set variables in."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _reference_triple(monkeypatch, *args):
    import jax

    from stochastic_gradient_push_tpu.parallel import discovery as jdisc

    got = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: got.update(kw))
    jdisc.initialize_multihost(*args)
    return (got["coordinator_address"], got["num_processes"],
            got["process_id"])


LAUNCHES = {
    "flags": ({}, ("10.0.0.7:1234", 4, 2)),
    "slurm": ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8",
               "SLURM_LOCALID": "1", "SLURM_JOB_NODELIST": "gpu-[003-004]",
               "COORDINATOR_PORT": "29511"}, ()),
    "slurm_no_nodelist": ({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                           "HOSTNAME": "head-0"}, ()),
    "ompi_host_port": ({"OMPI_COMM_WORLD_RANK": "3",
                        "OMPI_COMM_WORLD_SIZE": "4",
                        "COORDINATOR_ADDRESS": "mpi-head:4444"}, ()),
    "ompi_host_and_port": ({"OMPI_COMM_WORLD_RANK": "1",
                            "OMPI_UNIVERSE_SIZE": "2",
                            "COORDINATOR_ADDRESS": "mpi-head",
                            "COORDINATOR_PORT": "5555"}, ()),
    "ompi_one_node_hostname": ({"OMPI_COMM_WORLD_RANK": "1",
                                "OMPI_COMM_WORLD_SIZE": "2",
                                "OMPI_COMM_WORLD_LOCAL_SIZE": "2",
                                "HOSTNAME": "node-a"}, ()),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_discover_gives_the_references_triple(name, launch_env):
    env, flag_args = LAUNCHES[name]
    for k, v in env.items():
        launch_env.setenv(k, v)
    want = _reference_triple(launch_env, *flag_args)
    info = discovery.discover(dict(os.environ), _flags(*(
        ("True",) + flag_args)))
    assert (info.coordinator, info.world_size, info.rank) == want
    assert info.launcher == name.split("_")[0].replace("ompi", "mpi")
    assert info.init_method == f"tcp://{want[0]}"


def test_a_multi_node_mpi_launch_without_a_coordinator_is_refused(
        launch_env):
    for k, v in {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8",
                 "OMPI_COMM_WORLD_LOCAL_SIZE": "4"}.items():
        launch_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="needs COORDINATOR_ADDRESS"):
        _reference_triple(launch_env)
    with pytest.raises(ValueError, match="needs COORDINATOR_ADDRESS"):
        discovery.discover(dict(os.environ), _flags())


@pytest.mark.parametrize("env", [
    {}, {"SLURM_NTASKS": "1"}, {"SLURM_NTASKS": "4"},
    {"OMPI_COMM_WORLD_SIZE": "2"}, {"OMPI_UNIVERSE_SIZE": "1"},
    {"JAX_COORDINATOR_ADDRESS": "h:1"}, {"SLURM_NTASKS": "x"},
], ids=["none", "slurm1", "slurm4", "ompi2", "universe1", "coordinator",
        "garbled"])
def test_multihost_env_is_the_references(env, launch_env):
    from stochastic_gradient_push_tpu.run.gossip_sgd import _multihost_env

    for k, v in env.items():
        launch_env.setenv(k, v)
    assert discovery.multihost_env(dict(os.environ)) == _multihost_env()
    # and torchrun's world, the port's launch before the flags
    assert discovery.multihost_env({"WORLD_SIZE": "2"})
    assert not discovery.multihost_env({"WORLD_SIZE": "1"})


def test_multihost_modes_and_local_ranks():
    slurm = {"SLURM_PROCID": "3", "SLURM_NTASKS": "4", "SLURM_LOCALID": "1",
             "SLURM_JOB_NODELIST": "n-[1-2]"}
    assert discovery.discover(slurm, _flags("False")).launcher == "single"
    info = discovery.discover(slurm, _flags("auto"))
    assert (info.launcher, info.rank, info.local_rank) == ("slurm", 3, 1)
    torchrun_env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}
    assert discovery.discover(torchrun_env, _flags("False")).launcher == \
        "torchrun"
    flags = _flags("True", "h:9", 4, 3)
    assert discovery.discover({}, flags).local_rank == 3
    assert discovery.discover({"LOCAL_RANK": "0"}, flags).local_rank == 0
    assert discovery.discover({"OMPI_COMM_WORLD_LOCAL_RANK": "2",
                               "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
                              flags).local_world_size == 2


@pytest.mark.parametrize("env,flags,match", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, _flags("auto", None, 4, None),
     "--num_processes 4 but the torchrun launcher started 2"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, _flags("auto", None, None, 1),
     "--process_id 1 but the torchrun launcher made this process 0"),
    ({}, _flags("auto", "h:1", 2, 0),
     "--coordinator_address with --multihost auto"),
    ({}, _flags("True", "h:1", None, 0), "--process_id 0 needs "
                                         "--num_processes"),
    ({}, _flags("maybe"), "--multihost maybe"),
], ids=["num_processes", "process_id", "auto_without_launcher",
        "no_num_processes", "bad_mode"])
def test_flag_sets_that_do_not_fit_are_refused(env, flags, match):
    with pytest.raises(ValueError, match=match):
        discovery.discover(env, flags)


# -- a second group on one held store ----------------------------------------

_REJOIN = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
from stochastic_gradient_push_torch.parallel import multihost
rank = int(sys.argv[2])
for gen in range(4):
    if gen and rank == gen % 2:
        # the peer reads this process's key before it is rewritten
        time.sleep(1.5)
    multihost.initialize_multihost("gloo", "cpu", timeout_s=15)
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    print(f"GEN {gen} {x.item()}", flush=True)
    dist.destroy_process_group()
"""


def test_a_second_group_on_a_held_store_joins():
    rdv = Rendezvous()
    procs = [rdv.popen([sys.executable, "-c", _REJOIN, REPO, str(r)], r, 2)
             for r in range(2)]
    logs = join(procs, timeout=90)
    for log in logs:
        assert all(f"GEN {g} 3.0" in log for g in range(4)), log


# -- the flag form against the torchrun environment ---------------------------

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
SGD = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_mlp",
       "--image_size", "8", "--num_classes", "4", "--batch_size", "2",
       "--num_epochs", "1", "--num_iterations_per_training_epoch", "2",
       "--num_itr_ignore", "0", "--print_freq", "1", "--graph_type", "5",
       "--backend", "gloo"]
LM = ["--device", "cpu", "--vocab_size", "64", "--d_model", "32",
      "--n_layers", "1", "--n_heads", "2", "--d_ff", "64", "--seq_len", "16",
      "--batch_size", "2", "--num_steps", "2", "--print_freq", "1"]


def _flag_form(module, argv, world=2):
    """``world`` children launched by the flags alone on a held store."""
    rdv = Rendezvous()
    return join([rdv.popen(
        [sys.executable, "-m", module, *argv, "--multihost", "True",
         "--coordinator_address", f"127.0.0.1:{rdv.port}",
         "--num_processes", str(world), "--process_id", str(r)],
        env={"PYTHONPATH": REPO}, drop=TORCHRUN_VARS) for r in range(world)])


def _torchrun(module, argv, world=2):
    return torchrun(world, lambda r: [sys.executable, "-m", module, *argv],
                    PYTHONPATH=REPO)


def _tensors(path):
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        elif isinstance(tree, torch.Tensor):
            out[prefix] = tree

    walk(torch.load(path, weights_only=False)["state"], "")
    return out


def _rows(path, drop):
    with open(path) as f:
        return [[c for i, c in enumerate(r) if i not in drop]
                for r in csv.reader(f)]


def _assert_same_files(a: Path, b: Path, names):
    for name in names:
        got, want = _tensors(a / name), _tensors(b / name)
        assert sorted(got) == sorted(want) and got, name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


def test_image_cli_flag_form_equals_the_torchrun_launch(tmp_path):
    flags, env = tmp_path / "flags", tmp_path / "env"
    logs = _flag_form("stochastic_gradient_push_torch.run.gossip_sgd",
                      SGD + ["--checkpoint_dir", str(flags)])
    assert "rank 0 of 2, one a process" in logs[0]
    _torchrun("stochastic_gradient_push_torch.run.gossip_sgd",
              SGD + ["--checkpoint_dir", str(env)])
    _assert_same_files(flags, env, [f"checkpoint_r{r}_n2.ckpt"
                                    for r in range(2)])
    timing = set(range(2, 11))
    got = _rows(flags / "out_r0_n2.csv", timing)
    assert got == _rows(env / "out_r0_n2.csv", timing) and len(got) > 5


def test_lm_cli_flag_form_equals_the_torchrun_launch(tmp_path):
    flags, env = tmp_path / "flags", tmp_path / "env"
    _flag_form("stochastic_gradient_push_torch.run.gossip_lm",
               LM + ["--checkpoint_dir", str(flags)])
    _torchrun("stochastic_gradient_push_torch.run.gossip_lm",
              LM + ["--checkpoint_dir", str(env)])
    _assert_same_files(flags, env, [f"lm_checkpoint_r{r}_n2.ckpt"
                                    for r in range(2)])
    rate = {4}       # tokens_per_sec
    got = _rows(flags / "lm_out_p0_n2.csv", rate)
    assert got == _rows(env / "lm_out_p0_n2.csv", rate) and len(got) == 3


# -- the deprecated alias --------------------------------------------------------


def test_gossip_comm_dtype_is_wire_dtype_bf16_with_the_warning(tmp_path,
                                                               capsys):
    argv = SGD[:-2] + ["--world_size", "2"]
    alias, _ = gossip_sgd.parse_config(argv + [
        "--checkpoint_dir", str(tmp_path / "a"), "--gossip_comm_dtype",
        "bf16"])
    assert capsys.readouterr().err == ("warning: --gossip_comm_dtype is "
                                       "deprecated; use --wire_dtype bf16\n")
    wire, _ = gossip_sgd.parse_config(argv + [
        "--checkpoint_dir", str(tmp_path / "a"), "--wire_dtype", "bf16"])
    assert alias == wire and alias.wire_dtype == "bf16"
    for flag, d in (("--gossip_comm_dtype", "a"), ("--wire_dtype", "b")):
        gossip_sgd.main(argv + ["--checkpoint_dir", str(tmp_path / d), flag,
                                "bf16"])
    _assert_same_files(tmp_path / "a", tmp_path / "b",
                       [f"checkpoint_r{r}_n2.ckpt" for r in range(2)])


def test_lm_alias_gives_the_same_first_step_and_refuses_a_conflict(
        tmp_path, capsys):
    argv = LM[:-4] + ["--num_steps", "1", "--world_size", "2"]
    got = gossip_lm.main(argv + ["--checkpoint_dir", str(tmp_path / "a"),
                                 "--gossip_comm_dtype", "bf16"])
    assert ("warning: --gossip_comm_dtype is deprecated; use --wire_dtype "
            "bf16") in capsys.readouterr().err
    want = gossip_lm.main(argv + ["--checkpoint_dir", str(tmp_path / "b"),
                                  "--wire_dtype", "bf16"])
    assert got["final_loss"] == want["final_loss"]
    _assert_same_files(tmp_path / "a", tmp_path / "b",
                       [f"lm_checkpoint_r{r}_n2.ckpt" for r in range(2)])
    with pytest.raises(SystemExit, match="--gossip_comm_dtype is a "
                                         "deprecated alias for --wire_dtype "
                                         "bf16 and conflicts with "
                                         "--wire_dtype int8"):
        gossip_lm.main(argv + ["--gossip_comm_dtype", "bf16",
                               "--wire_dtype", "int8"])
