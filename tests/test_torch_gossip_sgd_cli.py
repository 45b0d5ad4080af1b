"""The port's training CLI (``stochastic_gradient_push_torch.run.
gossip_sgd`` and ``run.gossip_sgd_adpsgd``) on the CPU.

* End to end at ``--device cpu`` (TinyCNN/TinyMLP, 8–16 px, world 4):
  every algorithm (AllReduce, SGP, OSGP, D-PSGD sync and overlap,
  AD-PSGD) and the options around them (int8 wire, the ``auto`` kernel
  lane, cosine LR with warmup, ``grad_accum``, label smoothing, bf16,
  per-rank CSVs, kept epochs), writing the reference's CSV header and
  rows and one checkpoint file per rank; through ``main`` and through
  ``python -m``.
* The reference's flag surface: every flag of its parser, with its
  default; every flag of a feature not ported refused by name (one
  parametrised test), as is graph 6 and every unported
  ``TrainerConfig`` field; ``--dataset imagefolder`` without
  ``--dataset_dir`` is refused (the image-folder runs themselves are
  ``tests/test_torch_imagefolder_cli.py``).
* ``--gossip_kernel pallas`` on the CPU raises ``KernelBackendError``
  naming the flag; with no ``--device`` the CLI runs on CUDA or raises
  ``DeviceUnavailableError``.
* Resume: one epoch, then ``--resume True`` to two, equals two epochs
  straight (every rank file's tensors equal) and continues the CSV;
  checkpoints of another world are refused by name.
* SIGUSR1 to a subprocess run: exit 75, four rank files, the overlap
  FIFO on disk drained.
* Resilience: ``--inject_faults``, ``--health_every``,
  ``--residual_floor`` and ``--error_feedback`` reach the config and the
  trainer (faults compiled into the algorithm, the monitor and policy
  set up, the EF residual in the state) and are validated with the
  reference's messages (EF needs a lossy wire and push-sum; faults need
  push-sum, and a bilateral run refuses them); an OSGP int8 run with
  EF, a fault plan and health logs ``gossip health:`` lines with
  ``ef_residual_rms`` and a ``gossip recovery:`` average, its rank
  files carry a non-zero residual and a drained FIFO; resume with EF
  and faults equals continuing, residual included, and a resume with
  other EF flags is refused.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.device import DeviceUnavailableError
from stochastic_gradient_push_torch.ops.gossip_kernel import (
    KernelBackendError)
from stochastic_gradient_push_torch.run import gossip_sgd, gossip_sgd_adpsgd
from stochastic_gradient_push_torch.supervise.reshard import (
    TornCheckpointError)
from stochastic_gradient_push_torch.train import loop as tloop
from torch_ckpt_sets import (assert_bit_equal, dcp_tensors, port_set,
                             reference_reshard)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SMALL = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
         "--image_size", "16", "--num_classes", "10", "--batch_size", "4",
         "--world_size", str(WORLD), "--num_epochs", "2",
         "--num_iterations_per_training_epoch", "3", "--num_itr_ignore",
         "1", "--print_freq", "1", "--verbose", "False"]
HEADER = ("Epoch,itr,BT(s),avg:BT(s),std:BT(s),NT(s),avg:NT(s),std:NT(s),"
          "DT(s),avg:DT(s),std:DT(s),Loss,avg:Loss,Prec@1,avg:Prec@1,"
          "Prec@5,avg:Prec@5,val")


def _rows(path, world=WORLD):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[:5] == ["BEGIN-TRAINING", f"World-Size,{world}",
                         "Num-DLWorkers,8", "Batch-Size,4", HEADER]
    return [line.split(",") for line in lines[5:]]


def _rank_files(path, tag="", world=WORLD):
    return [torch.load(os.path.join(path, f"{tag}checkpoint_r{r}_n{world}"
                                          ".ckpt"), weights_only=True)
            for r in range(world)]


@pytest.mark.parametrize("extra,module,name", [
    (["--all_reduce", "True", "--graph_type", "-1"], gossip_sgd, "ar"),
    ([], gossip_sgd, "sgp"),
    (["--overlap", "True", "--staleness", "2", "--gossip_kernel", "auto"],
     gossip_sgd, "sgp"),
    (["--overlap", "True", "--synch_freq", "1", "--wire_dtype", "int8",
      "--wire_block", "16", "--gossip_buckets", "2"], gossip_sgd, "sgp"),
    (["--push_sum", "False"], gossip_sgd, "dpsgd"),
    (["--push_sum", "False", "--overlap", "True", "--staleness", "2",
      "--global_avg_every", "2"], gossip_sgd, "dpsgd"),
    ([], gossip_sgd_adpsgd, "adpsgd"),
    (["--graph_type", "0", "--num_peers", "2"], gossip_sgd_adpsgd,
     "adpsgd"),
    (["--cosine_lr", "True", "--warmup", "True", "--grad_accum", "2",
      "--label_smoothing", "0.1", "--nesterov", "True",
      "--peers_per_itr_schedule", "0", "1", "1", "2", "--graph_type", "0"],
     gossip_sgd, "sgp"),
    (["--precision", "bf16", "--gossip_every", "2"], gossip_sgd, "sgp"),
    (["--model", "tiny_mlp", "--image_size", "8", "--per_rank_csv", "True",
      "--overwrite_checkpoints", "False", "--tag", "t_"], gossip_sgd, "sgp"),
])
def test_cli_trains_end_to_end_on_cpu(tmp_path, capsys, extra, module,
                                      name):
    result = module.main(SMALL + ["--checkpoint_dir", str(tmp_path)] + extra)
    assert f"algorithm {name}" in capsys.readouterr().out
    tag = "t_" if "--tag" in extra else ""
    csv_ranks = range(WORLD) if "--per_rank_csv" in extra else [0]
    for r in csv_ranks:
        rows = _rows(tmp_path / f"{tag}out_r{r}_n{WORLD}.csv")
        assert [row[:2] for row in rows] == [
            [str(e), str(i)] for e in range(2) for i in (0, 1, 2, 2, -1)]
        assert all(len(row) == 18 for row in rows)
        assert all(row[-1] == "-1" for row in rows if row[1] != "-1")
    files = _rank_files(tmp_path, tag)
    assert [f["state"]["step"] for f in files] == [6] * WORLD
    assert all("best_prec1" in f["meta"] and '"epoch": 2' in f["meta"]
               for f in files)
    if "--overwrite_checkpoints" in extra:
        assert (tmp_path / f"ep0_{tag}checkpoint_r3_n{WORLD}.ckpt").is_file()
    for f in files:
        for slot in f["state"]["gossip"]["in_flight"]:
            assert not slot["ps_weight"].any()
    assert 0.0 <= result["best_prec1"] <= 100.0


def test_module_entry_point_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run.gossip_sgd",
         *SMALL, "--checkpoint_dir", str(tmp_path), "--push_sum", "False"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "done:" in proc.stdout.splitlines()[-1]
    assert len(_rows(tmp_path / f"out_r0_n{WORLD}.csv")) == 10


def test_reference_flags_parse_with_reference_defaults():
    from stochastic_gradient_push_tpu.run.gossip_sgd import build_parser

    ref = {a.dest: a.default for a in build_parser()._actions
           if a.option_strings and a.dest != "help"}
    port = {a.dest: a.default for a in gossip_sgd.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    missing = sorted(set(ref) - set(port))
    assert not missing, f"reference flags the port does not parse: {missing}"
    assert {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]} == {}
    assert set(port) - set(ref) == {"device"}


# one value per unported flag, each away from its default
UNPORTED_VALUES = {
    "--fleet": "True", "--host_id": "0",
}


# flags ported since, each with a value (and the flags beside it) that
# is still refused naming it, by the reference's refusal: --stem_s2d on
# an odd image size (its space_to_depth's message);
# --nprocs_per_node 3 does not divide the world of 4; --metrics_every -1;
# --metrics_every 5 with no (an empty) --trace_dir; the deprecated
# --gossip_comm_dtype beside another --wire_dtype (resolve_wire_flags's
# message); and the launches jax.distributed.initialize refuses:
# --multihost True with no coordinator and no launcher, a coordinator
# without --num_processes and --process_id, --num_processes 0 and a
# --process_id outside --num_processes
REFUSED_VALUES = {
    "--stem_s2d": ("True", "--model", "resnet18", "--image_size", "33"),
    "--nprocs_per_node": ("3",),
    "--metrics_every": ("-1", "--trace_dir", "/nonexistent"),
    "--trace_dir": ("", "--metrics_every", "5"),
    "--gossip_comm_dtype": ("bf16", "--wire_dtype", "int8"),
    "--multihost": ("True",),
    "--coordinator_address": ("127.0.0.1:1", "--multihost", "True"),
    "--num_processes": ("0", "--multihost", "True",
                        "--coordinator_address", "127.0.0.1:1",
                        "--process_id", "0"),
    "--process_id": ("2", "--multihost", "True", "--coordinator_address",
                     "127.0.0.1:1", "--num_processes", "2"),
}


@pytest.mark.parametrize("flag", sorted(gossip_sgd.UNPORTED)
                         + sorted(REFUSED_VALUES))
def test_unported_flags_raise_naming_the_flag(tmp_path, flag):
    value, *extra = REFUSED_VALUES.get(flag, (UNPORTED_VALUES.get(flag),))
    with pytest.raises(SystemExit, match=flag):
        gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path), flag,
                                 value, *extra])


def test_every_unported_flag_has_a_test_value():
    assert set(UNPORTED_VALUES) == set(gossip_sgd.UNPORTED)


# the resilience flags: value, the extra flags they need, the config
# field and the value it must hold
RESILIENCE_FLAGS = {
    "--inject_faults": ("drop:0->1@0:4", [], "inject_faults",
                        "drop:0->1@0:4"),
    "--health_every": ("5", [], "health_every", 5),
    "--residual_floor": ("0.1", ["--health_every", "3"], "residual_floor",
                         0.1),
    "--error_feedback": ("True", ["--wire_dtype", "int8"], "error_feedback",
                         True),
}


@pytest.mark.parametrize("flag", sorted(RESILIENCE_FLAGS))
def test_resilience_flags_are_accepted_into_the_config(flag):
    value, extra, field, want = RESILIENCE_FLAGS[flag]
    cfg, _ = gossip_sgd.parse_config(SMALL + [flag, value] + extra)
    assert getattr(cfg, field) == want


@pytest.mark.parametrize("argv,exc,match", [
    (["--error_feedback", "True"], SystemExit, "needs a lossy --wire_dtype"),
    (["--error_feedback", "True", "--wire_dtype", "f32"], SystemExit,
     "needs a lossy --wire_dtype"),
    (["--error_feedback", "True", "--wire_dtype", "int8", "--push_sum",
      "False"], SystemExit, "push-sum knobs"),
    (["--inject_faults", "drop:0->1@0:4", "--all_reduce", "True",
      "--graph_type", "-1"], SystemExit, "--inject_faults needs push-sum"),
    (["--inject_faults", "drop:0->1@0:4", "--push_sum", "False"],
     SystemExit, "--inject_faults needs push-sum"),
    (["--inject_faults", "fog:1@0:2"], ValueError, "unknown fault kind"),
    (["--health_every", "-1"], SystemExit, "--health_every must be >= 0"),
])
def test_resilience_flags_are_validated(tmp_path, argv, exc, match):
    with pytest.raises(exc, match=match):
        gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path)] + argv)


def test_faults_are_refused_for_bilateral_runs(tmp_path):
    with pytest.raises(ValueError, match="inject_faults breaks gossip "
                                         "edges; all_reduce/bilateral"):
        gossip_sgd_adpsgd.main(SMALL + ["--checkpoint_dir", str(tmp_path),
                                        "--inject_faults", "drop:0->1@0:4"])


def test_resilience_run_logs_health_and_recovery(tmp_path, capsys):
    gossip_sgd.main(SMALL + [
        "--checkpoint_dir", str(tmp_path), "--verbose", "True",
        "--overlap", "True", "--staleness", "2", "--wire_dtype", "int8",
        "--error_feedback", "True", "--inject_faults",
        "drop:0->1@1:4;seed:5", "--health_every", "3", "--residual_floor",
        "1e-9"])
    out = capsys.readouterr().out
    health = [line for line in out.splitlines() if "gossip health: " in line]
    assert health and all('"ef_residual_rms"' in line for line in health)
    assert "push-sum-mass-leak" not in out
    assert "gossip faults: " in out
    assert '"action": "global-average"' in out
    for f in _rank_files(tmp_path):
        res = f["state"]["gossip"]["ef_residual"]
        assert any(t.any() for t in res.values())
        for slot in f["state"]["gossip"]["in_flight"]:
            assert not slot["ps_weight"].any()
            assert not any(t.any() for t in slot["params"].values())
        assert "ef_residual_rms" in f["meta"]


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "imagefolder"], "ImageFolder"),
    (["--all_reduce", "True", "--graph_type", "-1", "--topology", "auto"],
     "--topology selects a gossip graph"),
    (["--multihost", "False"], None),
    (["--model", "vit"], "unknown model"),
    (["--staleness", "2"], "overlap-mode knob"),
    (["--overlap", "True", "--staleness", "3", "--synch_freq", "1"],
     "conflicts"),
    (["--push_sum", "False", "--wire_dtype", "int8"], "push-sum knobs"),
    (["--all_reduce", "True"], "graph_type -1"),
    (["--graph_type", "-1"], "graph_type >= 0"),
    (["--peers_per_itr_schedule", "1", "2"], "epoch 0"),
    (["--schedule", "30"], "pairs"),
    (["--gossip_buckets", "0"], "gossip_buckets"),
])
def test_flags_are_validated(tmp_path, argv, match):
    argv = SMALL + ["--checkpoint_dir", str(tmp_path),
                    "--num_epochs", "1"] + argv
    if match is None:       # accepted: the feature stays off
        gossip_sgd.main(argv)
        return
    with pytest.raises(SystemExit, match=match):
        gossip_sgd.main(argv)


@pytest.mark.parametrize("field,value,extra", [
    ("inject_faults", "drop:0->1@0:4", {}),
    ("health_every", 4, {}),
    ("residual_floor", 0.25, {"health_every": 2}),
    ("error_feedback", True, {"wire_dtype": "bf16"}),
])
def test_resilience_trainer_fields_are_threaded(field, value, extra):
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch import topology
    from stochastic_gradient_push_torch.train.step import make_model

    cfg = tloop.TrainerConfig(
        graph_class=topology.NPeerDynamicDirectedExponentialGraph,
        **{field: value}, **extra)
    trainer = tloop.Trainer(cfg, make_model("tiny_cnn"),
                            StackedTransport(2), device="cpu")
    alg = trainer.make_algorithm(1)
    if field == "inject_faults":
        assert alg.faults.plan.summary() == \
            '{"events": [{"dst": 1, "end": 4, "kind": "drop", "src": 0, ' \
            '"start": 0}], "seed": 0}'
    elif field == "error_feedback":
        assert alg.error_feedback and alg.init(
            {"w": torch.zeros(2, 3)}).ef_residual is not None
    else:
        assert trainer.monitor.health_every == cfg.health_every
        assert trainer.monitor.residual_floor == cfg.residual_floor
        assert trainer.recovery_policy.residual_floor == cfg.residual_floor


# TrainerConfig fields ported since, each with a value still refused:
# (value, exception, message[, the fields beside it])
REFUSED_FIELDS = {"nprocs_per_node": (0, ValueError,
                                      "nprocs_per_node must be >= 1"),
                  "gossip_comm_dtype": ("f16", ValueError,
                                        "unknown gossip_comm_dtype 'f16'")}


@pytest.mark.parametrize("field", sorted(tloop.UNPORTED)
                         + sorted(REFUSED_FIELDS))
def test_unported_trainer_fields_raise_naming_the_feature(field):
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train.step import make_model

    beside = {}
    if field in REFUSED_FIELDS:
        value, exc, match, *more = REFUSED_FIELDS[field]
        beside = more[0] if more else {}
    else:
        default, feature = tloop.UNPORTED[field]
        value = {bool: not default, int: 7, float: 0.25}.get(
            type(default), "x")
        exc, match = NotImplementedError, feature.split(" (")[0]
        if field == "plan":
            value = {"topology": "ring"}
    cfg = tloop.TrainerConfig(**{field: value, **beside})
    with pytest.raises(exc, match=match):
        tloop.Trainer(cfg, make_model("tiny_cnn"), StackedTransport(2),
                      device="cpu")


# TrainerConfig fields the Trainer once refused and the reference's runs
# with the null telemetry bundle: metrics_every < 0 (clamped) and
# metrics_every without a trace_dir
NULL_BUNDLE_FIELDS = {"metrics_every": {"metrics_every": -1},
                      "trace_dir": {"metrics_every": 5, "trace_dir": ""}}


@pytest.mark.parametrize("field", sorted(NULL_BUNDLE_FIELDS))
def test_trainer_runs_with_the_null_bundle_as_the_reference(field, tmp_path):
    from stochastic_gradient_push_torch.data.pipeline import (
        DistributedSampler, ShardedLoader)
    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.telemetry import NULL_TELEMETRY
    from stochastic_gradient_push_torch.train.step import make_model

    cfg = tloop.TrainerConfig(**NULL_BUNDLE_FIELDS[field],
                              checkpoint_dir=str(tmp_path), batch_size=2,
                              num_epochs=1, num_itr_ignore=0, num_classes=4,
                              all_reduce=True, verbose=False)
    trainer = tloop.Trainer(cfg, make_model("tiny_mlp", num_classes=4),
                            StackedTransport(2), device="cpu")
    assert trainer.telemetry is NULL_TELEMETRY
    images, labels = synthetic_classification(8, num_classes=4,
                                              image_size=8, seed=0)
    sampler = DistributedSampler(8, 2)
    loader = ShardedLoader(images, labels, 2, sampler)
    _, result = trainer.fit(trainer.init_state(), loader, sampler)
    assert np.isfinite(result["best_prec1"])
    assert not list(tmp_path.rglob("events*.jsonl"))


def test_multi_process_world_is_refused():
    from stochastic_gradient_push_torch.train.step import make_model

    class OneRankTransport:
        world_size = 2

    with pytest.raises(NotImplementedError, match="multi-process world"):
        tloop.Trainer(tloop.TrainerConfig(), make_model("tiny_cnn"),
                      OneRankTransport(), device="cpu")


def test_pallas_on_cpu_is_a_typed_error_naming_the_flag(tmp_path):
    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas"):
        gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path),
                                 "--gossip_kernel", "pallas"])


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(DeviceUnavailableError):
        gossip_sgd.main(argv + ["--checkpoint_dir", str(tmp_path)])


@pytest.mark.parametrize("extra", [[], ["--overlap", "True", "--staleness",
                                        "2", "--push_sum", "False"],
                                   ["--overlap", "True", "--staleness", "2",
                                    "--wire_dtype", "int8", "--wire_block",
                                    "16", "--error_feedback", "True",
                                    "--inject_faults",
                                    "drop:0->1@1:5;nan:3@9:10;seed:5",
                                    "--health_every", "2"]])
def test_resume_equals_continue(tmp_path, extra):
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "a")]
                    + extra)
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "b"),
                             "--num_epochs", "1"] + extra)
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "b"),
                             "--resume", "True"] + extra)
    for a, b in zip(_rank_files(tmp_path / "a"), _rank_files(tmp_path / "b")):
        sa, sb = a["state"], b["state"]
        assert sa["step"] == sb["step"] == 6
        assert sa["gossip"]["phase"] == sb["gossip"]["phase"]
        assert torch.equal(sa["gossip"]["ps_weight"], sb["gossip"]["ps_weight"])
        for tree in ("params", "opt_state", "batch_stats"):
            for n, t in sa[tree].items():
                assert torch.equal(sb[tree][n], t), (tree, n)
        for x, y in zip(sa["gossip"]["in_flight"], sb["gossip"]["in_flight"]):
            assert torch.equal(x["ps_weight"], y["ps_weight"])
        assert ("ef_residual" in sa["gossip"]) == ("--error_feedback" in extra)
        for n, t in sa["gossip"].get("ef_residual", {}).items():
            assert torch.equal(sb["gossip"]["ef_residual"][n], t), n
    rows_a = _rows(tmp_path / "a" / f"out_r0_n{WORLD}.csv")
    rows_b = _rows(tmp_path / "b" / f"out_r0_n{WORLD}.csv")
    # the resumed run appends to the CSV: the same epochs and iterations,
    # and the same losses and accuracies
    assert [r[:2] + r[11:] for r in rows_b] == [r[:2] + r[11:]
                                                for r in rows_a]


def test_resume_with_other_error_feedback_flags_is_refused(tmp_path):
    ef = ["--wire_dtype", "int8", "--error_feedback", "True"]
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path),
                             "--num_epochs", "1"] + ef)
    resume = SMALL + ["--checkpoint_dir", str(tmp_path), "--resume", "True"]
    with pytest.raises(SystemExit, match="needs a lossy --wire_dtype"):
        gossip_sgd.main(resume + ["--error_feedback", "True"])
    with pytest.raises(ValueError, match="error-feedback residual does not "
                                         "match the run's"):
        gossip_sgd.main(resume + ["--wire_dtype", "int8"])


def test_cross_world_resume_is_refused_by_name(tmp_path):
    # where the reference does not reshard: a file holds a node's row
    # under --nprocs_per_node > 1, and the DCP backend is not resharded
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "a"),
                             "--num_epochs", "1"])
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .* world \[4\], not 8, "
                             r"and nprocs_per_node 2 > 1"):
        gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "a"),
                                 "--world_size", "8", "--nprocs_per_node",
                                 "2", "--resume", "True"])
    orbax = ["--ckpt_backend", "orbax", "--checkpoint_dir",
             str(tmp_path / "b")]
    gossip_sgd.main(SMALL + orbax + ["--num_epochs", "1"])
    with pytest.raises(NotImplementedError,
                       match="cross-world resume: .*--ckpt_backend orbax"):
        gossip_sgd.main(SMALL + orbax + ["--world_size", "2", "--resume",
                                         "True"])
    # a --checkpoint_all False set holds rank 0's row alone
    gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "c"),
                             "--num_epochs", "1", "--checkpoint_all",
                             "False"])
    with pytest.raises(TornCheckpointError, match="--checkpoint_all False"):
        gossip_sgd.main(SMALL + ["--checkpoint_dir", str(tmp_path / "c"),
                                 "--world_size", "2", "--resume", "True"])


def test_a_torn_set_of_this_world_starts_over_with_a_warning(tmp_path,
                                                             capsys):
    argv = SMALL + ["--checkpoint_dir", str(tmp_path), "--num_epochs", "1"]
    gossip_sgd.main(argv)
    gossip_sgd.main(argv + ["--world_size", "2"])
    os.remove(tmp_path / "checkpoint_r1_n2.ckpt")
    capsys.readouterr()
    gossip_sgd.main(argv + ["--world_size", "2", "--resume", "True"])
    out = capsys.readouterr().out
    assert "a checkpoint of this world is on disk but incomplete" in out
    assert "resharded" not in out and "resumed from" not in out


def _state_of(directory, world):
    """The tensors, step and phase of every rank file of a set."""
    out = {}
    for r, f in enumerate(_rank_files(directory, world=world)):
        s = f["state"]
        out[(r, "step")] = torch.tensor(s["step"])
        out[(r, "phase")] = torch.tensor(s["gossip"]["phase"])
        out[(r, "ps")] = s["gossip"]["ps_weight"]
        for tree in ("params", "opt_state", "batch_stats"):
            out.update({(r, tree, n): t for n, t in s[tree].items()})
    return out


@pytest.mark.parametrize("module,extra", [
    (gossip_sgd, []),
    (gossip_sgd, ["--overlap", "True", "--staleness", "2"]),
    (gossip_sgd_adpsgd, []),
], ids=["sgp", "osgp", "adpsgd"])
def test_resume_at_another_world_reshards(tmp_path, module, extra):
    """World 4 for one epoch, resumed at world 2: the resharded files
    are the reference's reshard of the port's world-4 files, bit for
    bit, and the resumed run equals a same-world resume from them."""
    old = SMALL + extra + ["--num_epochs", "1"]
    module.main(old + ["--checkpoint_dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = reference_reshard(tmp_path / "a", "", WORLD, 2)
    new = SMALL + extra + ["--world_size", "2", "--resume", "True"]
    # resumed at its last epoch: the reshard writes the set, no step runs
    module.main(new + ["--num_epochs", "1", "--checkpoint_dir",
                       str(tmp_path / "a")])
    assert_bit_equal(port_set(tmp_path / "a", "", 2), want)
    meta = json.loads(_rank_files(tmp_path / "a", world=2)[0]["meta"])
    assert meta["reshard"]["old_world"] == WORLD and meta["epoch"] == 1
    # a same-world resume from the resharded set, and the cross-world
    # resume straight from the world-4 set
    module.main(new + ["--num_epochs", "2", "--checkpoint_dir",
                       str(tmp_path / "a")])
    module.main(new + ["--num_epochs", "2", "--checkpoint_dir",
                       str(tmp_path / "b")])
    a, b = _state_of(tmp_path / "a", 2), _state_of(tmp_path / "b", 2)
    assert sorted(a) == sorted(b) and a[(0, "step")] == 3 + 3
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert _rows(tmp_path / "b" / "out_r0_n2.csv", world=2)[-1][1] == "-1"


def test_resume_under_the_dcp_backend_equals_the_rank_files(tmp_path):
    """--ckpt_backend orbax: one epoch then a resume to two, against the
    same run on the per-rank files (the reference's
    tests/test_run_layer.py:326)."""
    for backend, d in (("msgpack", "p"), ("orbax", "d")):
        argv = SMALL + ["--ckpt_backend", backend, "--checkpoint_dir",
                        str(tmp_path / d), "--overlap", "True"]
        gossip_sgd.main(argv + ["--num_epochs", "1"])
        gossip_sgd.main(argv + ["--resume", "True"])
    assert sorted(os.listdir(tmp_path / "d")) == [
        f"dcp_r0_n{WORLD}", f"out_r0_n{WORLD}.csv"]
    root = tmp_path / "d" / f"dcp_r0_n{WORLD}"
    assert sorted(os.listdir(root)) == ["1", "2", "best"]
    got = dcp_tensors(root / "2")
    files = _rank_files(tmp_path / "p")
    for tree in ("params", "opt_state", "batch_stats"):
        for n in files[0]["state"][tree]:
            want = torch.stack([f["state"][tree][n] for f in files])
            assert torch.equal(got[f"state.{tree}.{n}"], want), (tree, n)
    assert torch.equal(got["state.ps_weight"], torch.stack(
        [f["state"]["gossip"]["ps_weight"] for f in files]))
    rows = [_rows(tmp_path / d / f"out_r0_n{WORLD}.csv") for d in "pd"]
    assert [r[:2] + r[11:] for r in rows[0]] == [r[:2] + r[11:]
                                                for r in rows[1]]


def test_sigusr1_exits_75_with_drained_rank_files(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run.gossip_sgd",
         *SMALL, "--num_epochs", "1000", "--overlap", "True", "--staleness",
         "2", "--checkpoint_dir", str(tmp_path)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    csv_path = tmp_path / f"out_r0_n{WORLD}.csv"
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and proc.poll() is None:
            if csv_path.exists() and len(csv_path.read_text()
                                         .splitlines()) >= 7:
                break
            time.sleep(0.1)
        assert proc.poll() is None, proc.stdout.read()
        proc.send_signal(signal.SIGUSR1)
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, out
    # saved at the next step boundary, or by the epoch's own save when
    # the signal lands during validation
    assert "Received SIGUSR1" in out
    files = _rank_files(tmp_path)
    assert len(files) == WORLD
    for f in files:
        slots = f["state"]["gossip"]["in_flight"]
        assert len(slots) == 2
        for slot in slots:
            assert not slot["ps_weight"].any()
            assert not any(t.any() for t in slot["params"].values())
    assert '"itr": ' in files[0]["meta"]
