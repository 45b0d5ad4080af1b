"""Pipeline parallelism is the same function as pp 1, and its command
line (``--pp``, ``--n_micro``), on the stacked lane.

* **pp = pp 1**: two steps at dp 2 x pp 2 (L4, two microbatches) equal
  the non-pipelined step (``train/lm.py``) from the same seed-0 logical
  model on the same tokens, the pipeline state assembled into the
  ``TransformerLM`` tree (``models/convert.py::assemble``), losses,
  ``ppl`` and params at rtol/atol 2e-5: SGP, its gossip kernel lane's
  twin, OSGP, D-PSGD and AllReduce; the ``(gossip, pipe, seq)`` mesh with
  ``ring`` and ``ring_flash`` against the ``(gossip, seq)`` step; MoE on
  ``(gossip, pipe)`` and ``(gossip, pipe, ep)`` against the flat and
  ``(gossip, ep)`` steps at a capacity that drops nothing and no MoE loss
  (with one, each microbatch's load-balancing loss is its own: the
  objectives differ, as the reference's do).  Remat is bit-equal to no
  remat.
* **The command line**: the rows at ``--pp 2`` are the ``--pp 1`` rows
  (loss, ppl, lr and the validation's; ``grad_norm`` is the reference's
  mean of stage norms), and so are ``--pp 2 --sp 2``'s; MoE on the ``(gossip, pipe, ep)`` and
  ``(gossip, pipe, ep, seq)`` meshes trains with ``moe_dropped`` in [0,
  1]; a stacked run resumed from its step-2 files equals the straight
  run (rows and files); every reference refusal fires with its message,
  and cross-world resume at pp > 1 is refused by name.  Under a torchrun
  environment ``--pp 2 --sp 2`` runs in four processes with the stacked
  run's rows, and ``--pp`` × ``--tp`` stays refused by its message.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models.convert import (
    assemble, flatten_tree, params_to_jax)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import StackedEp
from stochastic_gradient_push_torch.parallel.pipeline import StackedPipe
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.run import gossip_lm
import torch_pp_drive as drive

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pp_params(got: dict, pp: int) -> dict:
    return flatten_tree(assemble(params_to_jax(
        {k.split("/", 1)[1]: v for k, v in got.items()
         if k.startswith("params/")}, pp=pp)))


@pytest.mark.parametrize("name,sp,impl,ep,moe", [
    ("sgp", 1, None, 1, False),
    ("sgp_twin", 1, None, 1, False),
    ("osgp", 1, None, 1, False),
    ("dpsgd", 1, None, 1, False),
    ("allreduce", 1, None, 1, False),
    ("sgp", 2, "ring", 1, False),
    ("sgp", 2, "ring_flash", 1, False),
    ("sgp", 1, None, 1, True),
    ("sgp", 1, None, 2, True),
])
def test_pp_is_the_same_function_as_pp1(name, sp, impl, ep, moe):
    dp, pp = 2, 2
    n_layers = 2 if moe else 4
    kw = dict(cf=8.0, coef=0.0) if moe else {}
    data = drive.batches(dp, ep, sp, 7)
    got = drive.run(name, dp, StackedTransport(dp), StackedPipe(pp), data,
                    n_layers, sp, StackedSeq(sp) if sp > 1 else None,
                    StackedEp(ep) if ep > 1 else None, moe, impl, **kw)
    want = drive.flat_run(name, dp, data, n_layers, sp, ep, moe, impl, **kw)
    for k in want:
        if k != "params":
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    mine, ref = _pp_params(got, pp), flatten_tree(want["params"])
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("sp,moe", [(1, False), (2, True)])
def test_remat_is_bit_equal(sp, moe):
    dp, pp, ep = 2, 2, 1
    data = drive.batches(dp, ep, sp, 8)
    runs = [drive.run("sgp", dp, StackedTransport(dp), StackedPipe(pp),
                      data, 2 if moe else 4, sp,
                      StackedSeq(sp) if sp > 1 else None, None, moe,
                      remat=remat) for remat in (False, True)]
    assert set(runs[0]) == set(runs[1])
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k]), k


def test_stacked_pipe_moves_the_stage_list():
    pipe = StackedPipe(3)
    assert pipe.hand_off(["a", "b", "c"]) == ["c", "a", "b"]
    assert pipe.sum_stages([1, 2]) == [1, 2]
    assert torch.equal(pipe.mean_stages(torch.tensor([[1.0], [3.0]])),
                       torch.tensor([2.0]))
    with pytest.raises(ValueError, match="pp must be >= 1"):
        StackedPipe(0)


# -- the command line --------------------------------------------------------

SMALL = ["--device", "cpu", "--vocab_size", "64", "--d_model", "32",
         "--n_layers", "4", "--n_heads", "4", "--d_ff", "64",
         "--seq_len", "16", "--batch_size", "4", "--n_micro", "2",
         "--print_freq", "1", "--corpus_tokens", "4000"]


def _rows(out: str) -> list:
    return [ln.split(",") for ln in out.splitlines()
            if ln.split(",")[0].isdigit()]


def test_cli_rows_at_pp2_are_the_pp1_rows(tmp_path, capsys):
    """The reference's ``test_pp_sp_matches_pp_only``, with pp 1 beside
    it: the same tokens, the same logical init, the same function."""
    runs = {}
    for tag, mesh, log in (
            ("pp1", ["--world_size", "2"], "world 2 (2 in this process)"),
            ("pp2", ["--world_size", "4", "--pp", "2"],
             "world 4 = dp 2 x pp 2 (2 in this process)"),
            ("pp2sp2", ["--world_size", "8", "--pp", "2", "--sp", "2",
                        "--attn", "ring_flash"],
             "world 8 = dp 2 x pp 2 x sp 2 (2 in this process)")):
        gossip_lm.main(SMALL + mesh + ["--num_steps", "3", "--val_frac",
                                       "0.25", "--val_batches", "2",
                                       "--checkpoint_dir",
                                       str(tmp_path / tag)])
        out = capsys.readouterr().out
        runs[tag] = _rows(out)
        assert len(runs[tag]) == 3 and log in out
        assert ("pipeline 2 stages x 2 microbatches (bubble 0.333)" in out) \
            == (tag != "pp1")
    for tag in ("pp2", "pp2sp2"):
        for a, b in zip(runs[tag], runs["pp1"]):
            # loss, ppl, lr (grad_norm: the mean of the stages' norms)
            np.testing.assert_allclose(np.float64(a[1:4]), np.float64(b[1:4]),
                                       rtol=0, atol=2e-4, err_msg=tag)
        # the last row's validation (the pp eval step) is pp 1's
        np.testing.assert_allclose(np.float64(runs[tag][-1][-2:]),
                                   np.float64(runs["pp1"][-1][-2:]),
                                   rtol=0, atol=2e-4, err_msg=tag)
    # the pipelined runs agree on the grad norm too
    for a, b in zip(runs["pp2"], runs["pp2sp2"]):
        np.testing.assert_allclose(float(a[5]), float(b[5]), atol=2e-4)


@pytest.mark.parametrize("mesh,log", [
    (["--world_size", "4", "--pp", "2", "--ep", "2"],
     "world 4 = dp 1 x pp 2 x ep 2 (1 in"),
    (["--world_size", "8", "--pp", "2", "--ep", "2", "--sp", "2", "--attn",
      "ring_flash", "--remat", "True"],
     "world 8 = dp 1 x pp 2 x ep 2 x sp 2 (1 in"),
])
def test_cli_trains_moe_on_the_pipeline_meshes(tmp_path, capsys, mesh, log):
    result = gossip_lm.main(SMALL + mesh + [
        "--moe_experts", "4", "--moe_every", "1", "--n_layers", "2",
        "--num_steps", "2", "--checkpoint_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(result["final_loss"]) and log in out
    assert "step,loss,ppl,lr,tokens_per_sec,grad_norm,moe_dropped" in out
    rows = _rows(out)
    assert len(rows) == 2 and all(0 <= float(r[-1]) <= 1 for r in rows)


@pytest.mark.parametrize("extra", [[], ["--overlap", "True", "--staleness",
                                        "2", "--wire_dtype", "int8"]])
def test_cli_resume_equals_continue(tmp_path, capsys, extra):
    """dp 2 x pp 2 stacked: 3 steps straight equal 2 steps then a resume
    to 3 (rows outside tokens/s, and the files, which hold the replica's
    ``[pp, L/pp, ...]`` stage leaves); both save at step 2, which drains
    an OSGP run's FIFO."""
    argv = SMALL + ["--world_size", "4", "--pp", "2", "--ckpt_every",
                    "2"] + extra

    def files(ckpt):
        return [torch.load(ckpt / f"lm_checkpoint_r{r}_n4.ckpt",
                           weights_only=True)["state"] for r in range(2)]

    straight, split = tmp_path / "straight", tmp_path / "split"
    gossip_lm.main(argv + ["--num_steps", "3", "--checkpoint_dir",
                           str(straight)])
    rows = _rows(capsys.readouterr().out)
    gossip_lm.main(argv + ["--num_steps", "2", "--checkpoint_dir",
                           str(split)])
    first = _rows(capsys.readouterr().out)
    assert tuple(files(split)[0]["params"]["stack.attn.q.weight"].shape) \
        == (2, 2, 32, 32)
    gossip_lm.main(argv + ["--num_steps", "3", "--resume", "True",
                           "--checkpoint_dir", str(split)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out

    def strip(rs):
        return [r[:4] + r[5:] for r in rs]

    assert len(rows) == 3 and strip(first + _rows(out)) == strip(rows)
    for a, b in zip(files(straight), files(split)):
        for part in ("params", "opt_state"):
            assert all(torch.equal(a[part][n], b[part][n])
                       for n in a[part]), part


@pytest.mark.parametrize("argv,match", [
    (["--pp", "2", "--tp", "2", "--world_size", "4"],
     r"--pp composes with gossip DP, --sp, --moe_experts and --ep only "
     r"\(not --tp\)"),
    (["--pp", "2", "--ep", "2", "--world_size", "4"],
     r"--pp with --ep requires --moe_experts > 0"),
    (["--pp", "2", "--moe_experts", "4", "--world_size", "2"],
     r"--pp with --moe_experts requires --moe_every 1 \(the stage stack is "
     r"one uniform scan\)"),
    (["--pp", "2", "--n_micro", "0", "--world_size", "2"],
     r"--n_micro must be >= 1 \(got 0\)"),
    (["--pp", "3", "--world_size", "3"], "n_layers 4 not divisible by pp 3"),
    (["--pp", "2", "--batch_size", "3", "--world_size", "2"],
     "batch_size 3 not divisible by n_micro 2"),
    (["--pp", "2", "--attn", "ring", "--world_size", "2"],
     r"--pp with ring attention needs --sp > 1 \(the 3-D gossip × pipe × "
     r"seq mesh\)"),
    (["--pp", "2", "--grad_accum", "2", "--world_size", "2"],
     r"--grad_accum composes with the flat meshes; pipeline runs control "
     r"microbatching with --n_micro"),
    (["--pp", "2", "--health_every", "1", "--world_size", "2"],
     r"--health_every composes with the flat dp and dp×sp meshes only "
     r"\(not ep/tp/pp\)"),
    (["--pp", "2", "--world_size", "3"],
     r"world_size 3 not divisible by sp\*tp\*ep\*pp 2"),
    (["--pp", "0"], "--sp, --tp, --ep and --pp must be >= 1"),
    (["--pp", "2", "--n_layers", "2", "--world_size", "4", "--wire_dtype",
      "int8"], r"stack\.ln1\.weight's stage holds 32 elements, not a "
               r"multiple of --wire_block 64"),
])
def test_cli_refusals_keep_the_reference_messages(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + ["--num_steps", "1", "--checkpoint_dir",
                                str(tmp_path)] + argv)


def test_cli_refuses_cross_world_resume_at_pp(tmp_path):
    (tmp_path / "lm_checkpoint_r0_n2.ckpt").write_bytes(b"")
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .*world \[2\].*--pp 2 > 1"):
        gossip_lm.main(SMALL + ["--world_size", "4", "--pp", "2",
                                "--num_steps", "2", "--resume", "True",
                                "--checkpoint_dir", str(tmp_path)])


def test_pp_with_sp_or_ep_across_processes_is_refused_by_name(monkeypatch,
                                                               tmp_path):
    """The refusal of ``--pp`` with ``--sp`` or ``--ep`` under torchrun is
    lifted: ``(gossip, pipe, seq)`` runs in four processes and prints the
    stacked run's rows.  What stays refused by name under torchrun is
    the reference's ``--pp`` × ``--tp``."""
    import sys

    from torch_launch import torchrun

    argv = SMALL + ["--pp", "2", "--sp", "2", "--attn", "ring",
                    "--num_steps", "2"]
    logs = torchrun(4, lambda r: [
        sys.executable, "-m", "stochastic_gradient_push_torch.run.gossip_lm",
        *argv, "--checkpoint_dir", str(tmp_path / "procs")])
    assert "world 4 = dp 1 x pp 2 x sp 2 (process 0: replica 0, stage 0, " \
        "shard 0)" in logs[0]
    gossip_lm.main(argv + ["--world_size", "4", "--checkpoint_dir",
                           str(tmp_path / "stacked")])
    procs, stacked = ([r.split(",") for r in (
        tmp_path / csv).read_text().splitlines()[1:]]
        for csv in ("procs/lm_out_p3_n4.csv", "stacked/lm_out_n4.csv"))
    assert len(procs) == len(stacked) == 2
    # step, loss, ppl, lr, grad_norm, one unit of the last printed digit
    # apart at most (the sequence mean is taken per process)
    unit = np.array([0, 1e-4, 1e-2, 1e-5, 1e-4]) * (1 + 1e-6)
    for g, w in zip(procs, stacked):
        g, w = g[:4] + g[5:], w[:4] + w[5:]
        assert np.all(np.abs(np.float64(g) - np.float64(w)) <= unit), (g, w)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "8"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", "29999")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=r"--pp composes with gossip DP, "
                                         r"--sp, --moe_experts and --ep "
                                         r"only \(not --tp\)"):
        gossip_lm.main(SMALL + ["--pp", "2", "--tp", "2", "--num_steps",
                                "1", "--checkpoint_dir", str(tmp_path)])
