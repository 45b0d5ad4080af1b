"""The port's LM CLI (``stochastic_gradient_push_torch.run.gossip_lm``) on
the CPU: a 3-step run at vocab 256 through ``main`` and through
``python -m``, the same run under ``torchrun`` (two gloo processes, one
rank each) printing the stacked lane's rows, the reference's flag
surface (every flag of the JAX package's parser, with its default), and
the refusal, by name, of every flag whose feature is not ported yet, and
of the reference's ``--tp`` refusals (``--tp`` itself trains: its
tests are ``tests/test_torch_tp*.py``; ``--moe_experts`` and ``--ep``
train too: ``tests/test_torch_ep_lm.py``, ``test_torch_ep_dist.py``).
Every run writes its CSV and checkpoints into a temporary
``--checkpoint_dir`` (the harness's own tests are
``tests/test_torch_lm_harness*.py``).
The overlap (OSGP) and gossip-kernel flags: ``--overlap True
--staleness 2`` trains on the CPU; ``--gossip_kernel pallas`` raises
``KernelBackendError`` naming the flag on ``--device cpu``, under
``torchrun`` naming the cross-process transport kernel (its twin runs in
``tests/test_torch_gossip_kernel_dist.py``).  The
resilience flags (``--inject_faults``, ``--health_every``,
``--residual_floor``, ``--error_feedback``) run, each printing its
lines (``gossip faults:``, ``gossip health:``, ``gossip recovery:``),
and are validated with the reference's messages.  Sequence parallelism
(``--sp``, ``--attn ring|ring_flash|blockwise``, ``--remat``) trains on
the CPU with the shards stacked, and its sizes are validated with the
reference's messages; under ``torchrun`` at ``--sp > 1`` the DCP backend
refuses a checkpoint of another world by name (the process ring itself
runs in
``tests/test_torch_lm_harness_dist.py`` and ``test_torch_seq_dist.py``).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.device import DeviceUnavailableError
from stochastic_gradient_push_torch.run import gossip_lm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "1", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--num_steps", "3",
         "--print_freq", "1", "--corpus_tokens", "4000"]



@pytest.fixture
def small(tmp_path):
    """``SMALL`` writing its CSV and checkpoints into a temporary
    directory (an LM run writes both)."""
    return SMALL + ["--checkpoint_dir", str(tmp_path / "ckpt")]

@pytest.mark.parametrize("extra", [
    ["--world_size", "4"],
    ["--world_size", "4", "--wire_dtype", "int8", "--peers_per_itr", "2",
     "--graph_type", "0"],
    ["--world_size", "2", "--all_reduce", "True", "--attn", "full"],
    ["--grad_accum", "2", "--nesterov", "True", "--warmup", "True"],
    ["--world_size", "4", "--overlap", "True", "--staleness", "2",
     "--wire_dtype", "bf16", "--peers_per_itr", "2"],
    ["--world_size", "4", "--gossip_kernel", "auto", "--gossip_buckets",
     "3"],
])
def test_three_steps_on_cpu(extra, capsys, small):
    result = gossip_lm.main(small + extra)
    out = capsys.readouterr().out.splitlines()
    header = out.index("step,loss,ppl,lr,tokens_per_sec,grad_norm")
    rows = [r.split(",") for r in out[header + 1:header + 4]]
    assert [r[0] for r in rows] == ["1", "2", "3"]
    assert all(math.isfinite(float(v)) for r in rows for v in r)
    assert math.isfinite(result["final_loss"])
    # an untrained LM sits near the uniform loss ln(256) = 5.55
    assert 4.5 < result["final_loss"] < 7.0


def test_module_entry_point_runs(small):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run.gossip_lm",
         *small, "--world_size", "2"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"final_loss"' in proc.stdout.splitlines()[-1]


def _rows(stdout: str) -> list[list[str]]:
    """The CSV rows without the tokens/s column (a host timing)."""
    lines = stdout.splitlines()
    start = lines.index("step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1
    # a row's first field is its step (the processes' log lines, such as
    # the signal handlers' under torchrun, start with a rank and a colon)
    return [r.split(",")[:4] + r.split(",")[5:] for r in lines[start:]
            if r.split(",")[0].isdigit()]


def test_torchrun_lane_prints_the_stacked_lanes_rows(tmp_path):
    # both lanes run in children on one torch thread (OMP_NUM_THREADS)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = ["-m", "stochastic_gradient_push_torch.run.gossip_lm", *SMALL,
            "--wire_dtype", "int8"]
    stacked = subprocess.run(
        [sys.executable, *argv, "--world_size", "2", "--checkpoint_dir",
         str(tmp_path / "stacked")], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    launched = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *argv, "--checkpoint_dir",
         str(tmp_path / "launched")], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert stacked.returncode == 0, stacked.stderr
    assert launched.returncode == 0, launched.stderr
    assert "world 2 (1 in this process)" in launched.stdout
    assert len(_rows(stacked.stdout)) == 3
    assert _rows(launched.stdout) == _rows(stacked.stdout)


def test_reference_flags_parse_with_reference_defaults():
    from stochastic_gradient_push_tpu.run.gossip_lm import build_parser

    ref = {a.dest: a.default for a in build_parser()._actions
           if a.option_strings and a.dest != "help"}
    port = {a.dest: a.default for a in gossip_lm.build_parser()._actions
            if a.option_strings and a.dest != "help"}
    missing = sorted(set(ref) - set(port))
    assert not missing, f"reference flags the port does not parse: {missing}"
    differ = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not differ
    # --attn unset resolves to ring under --sp > 1 (as the reference) and
    # to flash otherwise (the reference picks full off a TPU)
    assert port["attn"] is None and set(port) - set(ref) == {"device"}


@pytest.mark.parametrize("flag,value", [
    ("--tp", "2"), ("--ep", "2"), ("--pp", "2"),
    ("--slice_size", "2"),
    ("--metrics_every", "-1"),
    ("--moe_experts", "4"), ("--mixing_alpha", "0.5"),
    ("--trace_dir", ""),
    ("--gossip_comm_dtype", "bf16"), ("--multihost", "True"),
    ("--process_id", "2"),
])
def test_unported_flags_raise_naming_the_flag(flag, value, small):
    # --tp, --ep, --moe_experts, --pp, --metrics_every and --trace_dir are
    # ported; their cases keep a refusal of the reference's that names
    # the flag: --tp with ring attention at --sp 1, --ep without
    # --moe_experts, for --moe_experts the same refusal (a later
    # --moe_experts 0 wins, with --ep 2 under --tp 2), --pp with --tp,
    # --metrics_every -1, and --metrics_every 5 with no (an empty)
    # --trace_dir; the deprecated --gossip_comm_dtype beside another
    # --wire_dtype, and the launches jax.distributed.initialize refuses
    # (no coordinator and no launcher; a --process_id outside
    # --num_processes)
    extra = {"--tp": ["--n_heads", "2", "--attn", "ring", "--world_size",
                      "2"],
             "--pp": ["--tp", "2", "--n_heads", "2", "--world_size", "4"],
             "--moe_experts": ["--tp", "2", "--n_heads", "2", "--ep", "2",
                               "--world_size", "4", "--moe_experts",
                               "0"],
             "--metrics_every": ["--trace_dir", "/tmp/x"],
             "--trace_dir": ["--metrics_every", "5"],
             "--gossip_comm_dtype": ["--wire_dtype", "int8"],
             "--process_id": ["--multihost", "True", "--num_processes", "2",
                              "--coordinator_address", "127.0.0.1:1"],
             }.get(flag, [])
    with pytest.raises(SystemExit, match=flag):
        gossip_lm.main(small + [flag, value] + extra)


@pytest.mark.parametrize("argv,match", [
    (["--n_heads", "2", "--health_every", "2"],
     "--health_every composes with the flat dp and dp×sp meshes only "
     r"\(not ep/tp/pp\)"),
    (["--n_heads", "2", "--attn", "ring"],
     r"--tp with ring attention requires --sp > 1 \(3-D mesh\)"),
    (["--d_model", "31"], "d_model 31 not divisible by tp 2"),
    (["--n_heads", "2", "--d_ff", "63"], "d_ff 63 not divisible by tp 2"),
    (["--n_heads", "2", "--world_size", "6", "--sp", "2"],
     r"world_size 6 not divisible by sp\*tp\*ep\*pp 4"),
    (["--n_heads", "2", "--wire_dtype", "int8", "--world_size", "4"],
     r"block_0\.attn\.q\.weight's shard has out / tp = 16, not a multiple "
     "of --wire_block 64"),
])
def test_tp_refusals_keep_the_reference_messages(argv, match, small):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(small + ["--tp", "2", "--world_size", "2"] + argv)
    with pytest.raises(SystemExit, match="--sp, --tp, --ep and --pp must "
                                         "be >= 1"):
        gossip_lm.main(small + ["--tp", "0"])


def test_tp_default_agrees_with_the_reference():
    from stochastic_gradient_push_tpu.run.gossip_lm import build_parser

    def tp_action(parser):
        return next(a for a in parser._actions if a.dest == "tp")

    ref, port = tp_action(build_parser()), tp_action(
        gossip_lm.build_parser())
    assert ref.default == port.default == 1
    assert ref.type is port.type is int
    assert "--tp" not in gossip_lm.UNPORTED


@pytest.mark.parametrize("flag,value,extra", [
    ("--inject_faults", "drop:0->1@0:4", []),
    ("--health_every", "2", ["--print_freq", "1"]),
    ("--error_feedback", "True", ["--wire_dtype", "int8"]),
    ("--residual_floor", "1e-9", ["--health_every", "1",
                                  "--print_freq", "1", "--world_size",
                                  "4"]),
])
def test_resilience_flags_run(flag, value, extra, capsys, small):
    argv = small + [flag, value] + extra
    if "--world_size" not in argv:
        argv += ["--world_size", "2"]
    result = gossip_lm.main(argv)
    assert np.isfinite(result["final_loss"])
    out = capsys.readouterr().out
    if flag == "--inject_faults":
        assert "gossip faults: " in out
    if flag in ("--health_every", "--residual_floor"):
        assert "gossip health: " in out
    if flag == "--residual_floor":
        assert '"action": "global-average"' in out


@pytest.mark.parametrize("argv,match", [
    (["--error_feedback", "True"], "needs a lossy --wire_dtype"),
    (["--inject_faults", "drop:0->1@0:4", "--push_sum", "False"],
     "--inject_faults needs push-sum"),
    (["--inject_faults", "drop:0->1@0:4", "--bilat", "True"],
     "--inject_faults needs push-sum"),
    (["--health_every", "3", "--print_freq", "2"], "multiple of"),
])
def test_resilience_flags_are_validated(argv, match, small):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(small + argv)


@pytest.mark.parametrize("flag,value", [("--sp", "2"), ("--remat", "True")])
def test_sequence_flags_run(flag, value, capsys, small):
    """Refused until the sequence-parallel slice; now three steps, at
    world 4 (dp 2 x sp 2 for ``--sp 2``)."""
    result = gossip_lm.main(small + ["--world_size", "4", flag, value])
    assert math.isfinite(result["final_loss"])
    out = capsys.readouterr().out
    if flag == "--sp":
        assert "world 4 = dp 2 x sp 2" in out and "attn=ring;" in out
    else:
        assert "attn=flash remat;" in out


@pytest.mark.parametrize("flag,value,extra", [
    ("--precision", "bf16", []),
    ("--precision", "bf16", ["--world_size", "4", "--sp", "2", "--attn",
                             "ring_flash", "--remat", "True"]),
    ("--precision", "bf16", ["--world_size", "4", "--overlap", "True",
                             "--staleness", "2", "--peers_per_itr", "2"]),
    ("--precision", "fp32", ["--world_size", "2"]),
])
def test_precision_flag_runs(flag, value, extra, capsys, small):
    """Refused until the bf16 slice; now three steps at bf16 with flash,
    with ring_flash at dp 2 x sp 2 under remat, and with OSGP, each
    printing finite rows (and ``fp32``, the default, as before)."""
    result = gossip_lm.main(small + [flag, value] + extra)
    out = capsys.readouterr().out
    assert f"precision {value};" in out
    rows = _rows(out)
    assert len(rows) == 3 and all(math.isfinite(float(v)) for r in rows
                                  for v in r)
    assert 4.5 < result["final_loss"] < 7.0


def test_unknown_precision_is_refused(capsys, small):
    # as the reference's parser refuses it: argparse's invalid choice
    with pytest.raises(SystemExit) as exc:
        gossip_lm.main(small + ["--precision", "fp16"])
    assert exc.value.code == 2
    assert "invalid choice: 'fp16'" in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--attn", "ring"], "ring"),
    (["--attn", "blockwise"], "blockwise"),
    (["--attn", "ring_flash"], "ring_flash"),
])
def test_unported_modes_raise(argv, match, capsys, small):
    """Once refused by name, these attentions train now: the ring ones at
    dp 2 x sp 2, blockwise at sp 1; each prints its mode and a finite
    loss."""
    sp = [] if match == "blockwise" else ["--sp", "2"]
    result = gossip_lm.main(small + argv + ["--world_size", "4"] + sp)
    assert math.isfinite(result["final_loss"])
    assert f"attn={match};" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--world_size", "2", "--sp", "2", "--attn", "flash"],
     "--sp > 1 requires ring attention"),
    (["--world_size", "4", "--sp", "3"],
     "world_size 4 not divisible by sp"),
    (["--world_size", "3", "--sp", "3"], "seq_len 32 not divisible by sp 3"),
    (["--world_size", "2", "--sp", "2", "--attn", "ring_flash",
      "--attn_block", "8"], "--attn_block 8 with --attn ring_flash"),
    (["--attn_block", "8"], "--attn_block 8 with --attn flash"),
    (["--sp", "0"], "--sp must be >= 1"),
])
def test_sequence_flags_are_validated(argv, match, small):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(small + argv)


def test_sp_under_torchrun_refuses_the_dcp_backend_by_name(tmp_path):
    # the DCP backend holds a replica's sequence shards under torchrun now
    # (its (dp, sp, tp) placements, tests/test_torch_tp_dist.py); what it
    # still refuses by name there is a checkpoint of another world
    ckpt = tmp_path / "ckpt"
    (ckpt / "lm_dcp_global_n4").mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "stochastic_gradient_push_torch.run.gossip_lm", *SMALL, "--sp", "2",
         "--ckpt_backend", "orbax", "--resume", "True", "--checkpoint_dir",
         str(ckpt)], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert run.returncode != 0
    assert ("cross-world resume" in run.stderr + run.stdout
            and "--ckpt_backend orbax" in run.stderr + run.stdout), (
        run.stderr)


def test_sp_health_lines_keep_the_mass(capsys, small):
    """dp 2 x sp 2 with health every step: the gossip runs between the two
    replicas, and every health line shows ``ps_mass_err 0.0``."""
    gossip_lm.main(small + ["--world_size", "4", "--sp", "2", "--attn",
                            "ring_flash", "--health_every", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("gossip health: ")]
    assert len(lines) == 3
    assert all('"ps_mass_err": 0.0' in ln for ln in lines)


def test_blockwise_takes_its_block(capsys, small):
    result = gossip_lm.main(small + ["--attn", "blockwise", "--attn_block",
                                     "8"])
    assert math.isfinite(result["final_loss"])
    assert "attn=blockwise;" in capsys.readouterr().out


def test_default_device_is_cuda(small):
    argv = [a for a in small if a not in ("--device", "cpu")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(DeviceUnavailableError):
        gossip_lm.main(argv)


def test_pallas_on_cpu_is_a_typed_error_naming_the_flag(small):
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        KernelBackendError)

    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas"):
        gossip_lm.main(small + ["--world_size", "4", "--gossip_kernel",
                                "pallas"])


def test_pallas_under_torchrun_names_the_cross_process_transport(
        monkeypatch, small):
    # the cross-process transport kernel runs under torchrun now; off the
    # card it is a typed error naming it
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        KernelBackendError)

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas "
                                                 "under torchrun.*cross-"
                                                 "process"):
        gossip_lm.main(small + ["--gossip_kernel", "pallas"])


@pytest.mark.parametrize("argv,match", [
    (["--staleness", "2"], "overlap-mode knob"),
    (["--overlap", "True", "--staleness", "-1"], "staleness must be"),
    (["--gossip_buckets", "0"], "gossip_buckets must be"),
    (["--all_reduce", "True", "--overlap", "True"], "push-sum gossip"),
])
def test_overlap_and_kernel_flags_are_validated(argv, match, small):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(small + ["--world_size", "2"] + argv)
