"""The port's LM CLI (``stochastic_gradient_push_torch.run.gossip_lm``) on
the CPU: a 3-step run at vocab 256 through ``main`` and through
``python -m``, the same run under ``torchrun`` (two gloo processes, one
rank each) printing the stacked lane's rows, the reference's flag
surface (every flag of the JAX package's parser, with its default), and
the refusal, by name, of every flag whose feature is not ported yet.
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
reference's messages; under ``torchrun`` ``--sp > 1`` is refused, naming
the cross-process sequence ring.
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
def test_three_steps_on_cpu(extra, capsys):
    result = gossip_lm.main(SMALL + extra)
    out = capsys.readouterr().out.splitlines()
    header = out.index("step,loss,ppl,lr,tokens_per_sec,grad_norm")
    rows = [r.split(",") for r in out[header + 1:header + 4]]
    assert [r[0] for r in rows] == ["1", "2", "3"]
    assert all(math.isfinite(float(v)) for r in rows for v in r)
    assert math.isfinite(result["final_loss"])
    # an untrained LM sits near the uniform loss ln(256) = 5.55
    assert 4.5 < result["final_loss"] < 7.0


def test_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run.gossip_lm",
         *SMALL, "--world_size", "2"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"final_loss"' in proc.stdout.splitlines()[-1]


def _rows(stdout: str) -> list[list[str]]:
    """The CSV rows without the tokens/s column (a host timing)."""
    lines = stdout.splitlines()
    start = lines.index("step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1
    return [r.split(",")[:4] + r.split(",")[5:] for r in lines[start:]
            if r and r[0].isdigit()]


def test_torchrun_lane_prints_the_stacked_lanes_rows():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = ["-m", "stochastic_gradient_push_torch.run.gossip_lm", *SMALL,
            "--wire_dtype", "int8"]
    stacked = subprocess.run([sys.executable, *argv, "--world_size", "2"],
                             capture_output=True, text=True, env=env,
                             cwd=REPO, timeout=300)
    launched = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *argv], capture_output=True, text=True,
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
    ("--resume", "True"),
    ("--checkpoint_dir", "/tmp/x"),
    ("--moe_experts", "4"), ("--mixing_alpha", "0.5"),
    ("--trace_dir", "/tmp/x"),
])
def test_unported_flags_raise_naming_the_flag(flag, value):
    with pytest.raises(SystemExit, match=flag):
        gossip_lm.main(SMALL + [flag, value])


@pytest.mark.parametrize("flag,value,extra", [
    ("--inject_faults", "drop:0->1@0:4", []),
    ("--health_every", "2", ["--print_freq", "1"]),
    ("--error_feedback", "True", ["--wire_dtype", "int8"]),
    ("--residual_floor", "1e-9", ["--health_every", "1",
                                  "--print_freq", "1", "--world_size",
                                  "4"]),
])
def test_resilience_flags_run(flag, value, extra, capsys):
    argv = SMALL + [flag, value] + extra
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
def test_resilience_flags_are_validated(argv, match):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + argv)


@pytest.mark.parametrize("flag,value", [("--sp", "2"), ("--remat", "True")])
def test_sequence_flags_run(flag, value, capsys):
    """Refused until the sequence-parallel slice; now three steps, at
    world 4 (dp 2 x sp 2 for ``--sp 2``)."""
    result = gossip_lm.main(SMALL + ["--world_size", "4", flag, value])
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
def test_precision_flag_runs(flag, value, extra, capsys):
    """Refused until the bf16 slice; now three steps at bf16 with flash,
    with ring_flash at dp 2 x sp 2 under remat, and with OSGP, each
    printing finite rows (and ``fp32``, the default, as before)."""
    result = gossip_lm.main(SMALL + [flag, value] + extra)
    out = capsys.readouterr().out
    assert f"precision {value};" in out
    rows = _rows(out)
    assert len(rows) == 3 and all(math.isfinite(float(v)) for r in rows
                                  for v in r)
    assert 4.5 < result["final_loss"] < 7.0


def test_unknown_precision_is_refused(capsys):
    # as the reference's parser refuses it: argparse's invalid choice
    with pytest.raises(SystemExit) as exc:
        gossip_lm.main(SMALL + ["--precision", "fp16"])
    assert exc.value.code == 2
    assert "invalid choice: 'fp16'" in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["--attn", "ring"], "ring"),
    (["--attn", "blockwise"], "blockwise"),
    (["--attn", "ring_flash"], "ring_flash"),
])
def test_unported_modes_raise(argv, match, capsys):
    """Once refused by name, these attentions train now: the ring ones at
    dp 2 x sp 2, blockwise at sp 1; each prints its mode and a finite
    loss."""
    sp = [] if match == "blockwise" else ["--sp", "2"]
    result = gossip_lm.main(SMALL + argv + ["--world_size", "4"] + sp)
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
def test_sequence_flags_are_validated(argv, match):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + argv)


def test_sp_under_torchrun_names_the_cross_process_ring(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--sp 2 under torchrun.*"
                                         "cross-process sequence ring"):
        gossip_lm.main(SMALL + ["--sp", "2"])


def test_sp_health_lines_keep_the_mass(capsys):
    """dp 2 x sp 2 with health every step: the gossip runs between the two
    replicas, and every health line shows ``ps_mass_err 0.0``."""
    gossip_lm.main(SMALL + ["--world_size", "4", "--sp", "2", "--attn",
                            "ring_flash", "--health_every", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("gossip health: ")]
    assert len(lines) == 3
    assert all('"ps_mass_err": 0.0' in ln for ln in lines)


def test_blockwise_takes_its_block(capsys):
    result = gossip_lm.main(SMALL + ["--attn", "blockwise", "--attn_block",
                                     "8"])
    assert math.isfinite(result["final_loss"])
    assert "attn=blockwise;" in capsys.readouterr().out


def test_default_device_is_cuda():
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default resolves to it")
    with pytest.raises(DeviceUnavailableError):
        gossip_lm.main(argv)


def test_pallas_on_cpu_is_a_typed_error_naming_the_flag():
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        KernelBackendError)

    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas"):
        gossip_lm.main(SMALL + ["--world_size", "4", "--gossip_kernel",
                                "pallas"])


def test_pallas_under_torchrun_names_the_cross_process_transport(
        monkeypatch):
    # the cross-process transport kernel runs under torchrun now; off the
    # card it is a typed error naming it
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        KernelBackendError)

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(KernelBackendError, match="--gossip_kernel pallas "
                                                 "under torchrun.*cross-"
                                                 "process"):
        gossip_lm.main(SMALL + ["--gossip_kernel", "pallas"])


@pytest.mark.parametrize("argv,match", [
    (["--staleness", "2"], "overlap-mode knob"),
    (["--overlap", "True", "--staleness", "-1"], "staleness must be"),
    (["--gossip_buckets", "0"], "gossip_buckets must be"),
    (["--all_reduce", "True", "--overlap", "True"], "push-sum gossip"),
])
def test_overlap_and_kernel_flags_are_validated(argv, match):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + ["--world_size", "2"] + argv)
