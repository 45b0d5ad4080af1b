"""The LM command line's harness (``run/gossip_lm.py``) across processes,
on the CPU with gloo, at 2 layers, d32, seq 32:

* SIGUSR1 to a run in a child process once its first CSV row is out: it
  saves (the OSGP FIFO drained) and exits 75; a resume completes to
  ``--num_steps`` and the CSV's rows run on without a gap.
* Two processes under a torchrun environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR/PORT`` set by hand): SIGUSR1 to one makes both save at
  one step and exit 75; a resume on two processes continues from that
  step, and its rows and rank files equal a straight stacked run's.  A
  torn save window (one process's file deleted) starts every process at
  step 0.
* ``--sp`` > 1 under torchrun, one sequence shard a process (dp 2 x sp 2
  with ``ring_flash`` and remat, dp 1 x sp 4 with ``ring``, 4
  processes): every process's CSV rows equal the stacked run's outside
  timing, and its file ``lm_checkpoint_r{replica}_s{shard}_n4.ckpt``
  equals its replica's other shards' bit for bit and the stacked
  replica's within 2e-6 (ps-weight exactly); SIGUSR1 to one process
  makes all four save at one step and exit 75, and the resume equals a
  straight run of the processes, rows and files bit for bit; a torn set
  starts every process at step 0; cross-world resume is refused by
  name.

Children are joined with timeouts; the stacked run in this process is
pinned to the children's one torch thread around the run.
"""

import json
import os
import signal
import sys
import time

import pytest
import torch

from stochastic_gradient_push_torch.run import gossip_lm
from torch_launch import Rendezvous

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "stochastic_gradient_push_torch.run.gossip_lm"
SMALL = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "1", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--print_freq", "1",
         "--warmup", "True", "--warmup_steps", "8",
         "--corpus_tokens", "4000"]
TIMEOUT = 240


def _spawn(argv, world=None):
    """The CLI in one child, or in ``world`` children of one group."""
    rdv = Rendezvous()
    return [rdv.popen([sys.executable, "-m", MODULE, *argv], r, world,
                      env={"PYTHONPATH": REPO}, cwd=REPO)
            for r in ([None] if world is None else range(world))]


def _join(procs, signal_to=None, when=None):
    """Every child's ``(returncode, log)``; with ``signal_to``, SIGUSR1
    goes to that child once ``when()`` holds."""
    try:
        if signal_to is not None:
            deadline = time.time() + TIMEOUT
            while not when():
                assert time.time() < deadline, "the run never got going"
                assert all(p.poll() is None for p in procs), \
                    "a child ended before the signal"
                time.sleep(0.05)
            signal_to.send_signal(signal.SIGUSR1)
        logs = [p.communicate(timeout=TIMEOUT)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().splitlines()


def _rows(path):
    """The CSV's rows, ``tokens_per_sec`` (a host timing) left out."""
    return [r.split(",")[:4] + r.split(",")[5:] for r in _lines(path)[1:]]


def _file(directory, r, world):
    blob = torch.load(os.path.join(directory,
                                   f"lm_checkpoint_r{r}_n{world}.ckpt"),
                      weights_only=True)
    return blob["state"], json.loads(blob["meta"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: torch.as_tensor(tree)}


def _one_thread(fn):
    """``fn()`` on one torch thread, as the children run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def test_sigusr1_saves_exits_75_and_a_resume_completes(tmp_path):
    n = 150   # far more steps than the child takes before the signal
    argv = SMALL + ["--world_size", "2", "--num_steps", str(n),
                    "--overlap", "True", "--staleness", "2",
                    "--checkpoint_dir", str(tmp_path)]
    csv = str(tmp_path / "lm_out_n2.csv")
    (proc,) = _spawn(argv)
    codes, logs = _join([proc], signal_to=proc,
                        when=lambda: len(_lines(csv)) >= 2)
    assert codes == [75], logs[0]
    assert "preemption signal (SIGUSR1)" in logs[0]
    states = [_file(tmp_path, r, 2) for r in range(2)]
    k = states[0][1]["step"]
    assert 1 <= k < n and all(m["step"] == k == s["step"]
                              for s, m in states)
    fifo = [t for s, _ in states
            for t in _flat(s["gossip"]["in_flight"]).values()]
    assert fifo and not any(t.any() for t in fifo)
    assert [r[0] for r in _rows(csv)] == [str(i + 1) for i in range(k)]
    result = gossip_lm.main(argv + ["--resume", "True"])
    assert "already_complete" not in result
    assert [r[0] for r in _rows(csv)] == [str(i + 1) for i in range(n)]
    assert _file(tmp_path, 0, 2)[1]["step"] == n


def test_torchrun_preemption_and_resume_continue_the_stacked_run(tmp_path):
    n, world = 80, 2
    dist, stacked = str(tmp_path / "dist"), str(tmp_path / "stacked")
    argv = SMALL + ["--num_steps", str(n), "--checkpoint_dir", dist]
    csv = os.path.join(dist, f"lm_out_p0_n{world}.csv")
    procs = _spawn(argv, world)
    codes, logs = _join(procs, signal_to=procs[1],
                        when=lambda: len(_lines(csv)) >= 3)
    assert codes == [75, 75], "\n".join(logs)
    steps = [_file(dist, r, world)[1]["step"] for r in range(world)]
    k = steps[0]
    assert steps == [k, k] and 2 <= k < n
    assert [r[0] for r in _rows(csv)] == [str(i + 1) for i in range(k)]

    codes, logs = _join(_spawn(argv + ["--resume", "True"], world))
    assert codes == [0, 0], "\n".join(logs)
    assert f"resumed from step {k}" in logs[0]
    _one_thread(lambda: gossip_lm.main(
        SMALL + ["--num_steps", str(n), "--world_size", str(world),
                 "--checkpoint_dir", stacked]))
    want = _rows(os.path.join(stacked, f"lm_out_n{world}.csv"))
    assert len(want) == n
    for p in range(world):
        assert _rows(os.path.join(dist, f"lm_out_p{p}_n{world}.csv")) == want
    for r in range(world):
        got, meta = _file(dist, r, world)
        ref, ref_meta = _file(stacked, r, world)
        assert meta == ref_meta
        got, ref = _flat(got), _flat(ref)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert torch.equal(got[key], ref[key]), (r, key)


def test_torn_save_window_starts_every_process_at_step_0(tmp_path):
    world = 2
    argv = SMALL + ["--checkpoint_dir", str(tmp_path)]
    codes, logs = _join(_spawn(argv + ["--num_steps", "2"], world))
    assert codes == [0, 0], "\n".join(logs)
    os.remove(tmp_path / f"lm_checkpoint_r1_n{world}.ckpt")
    codes, logs = _join(_spawn(argv + ["--num_steps", "3", "--resume",
                                       "True"], world))
    assert codes == [0, 0], "\n".join(logs)
    assert "checkpoint present here but missing on a peer; starting from " \
        "step 0" in logs[0]
    assert "no checkpoint for rank 1" in logs[1]
    assert "resumed from step" not in logs[0]
    assert [r[0] for r in _rows(tmp_path / f"lm_out_p0_n{world}.csv")] \
        == ["1", "2", "3"]
    assert all(_file(tmp_path, r, world)[1]["step"] == 3
               for r in range(world))


def test_cross_world_resume_under_torchrun_is_refused_by_name(tmp_path):
    # the reference reshards in one process only: every process refuses
    argv = SMALL + ["--checkpoint_dir", str(tmp_path), "--num_steps", "1"]
    codes, logs = _join(_spawn(argv + ["--world_size", "4"]))
    assert codes == [0], logs[0]
    codes, logs = _join(_spawn(argv + ["--resume", "True"], 2))
    assert codes[0] != 0 and codes[1] != 0, "\n".join(logs)
    for log in logs:
        assert ("NotImplementedError: cross-world resume" in log
                and "the run spans 2 processes" in log), log


def test_dcp_backend_under_torchrun_resumes_as_the_rank_files(tmp_path):
    """--ckpt_backend orbax in 2 processes: one shared root, each
    process's rows restored; the run equals the per-rank backend's."""
    world = 2
    for backend in ("msgpack", "orbax"):
        argv = SMALL + ["--checkpoint_dir", str(tmp_path / backend),
                        "--ckpt_backend", backend, "--ckpt_every", "1"]
        codes, logs = _join(_spawn(argv + ["--num_steps", "2"], world))
        assert codes == [0, 0], "\n".join(logs)
        codes, logs = _join(_spawn(argv + ["--num_steps", "4", "--resume",
                                           "True"], world))
        assert codes == [0, 0], "\n".join(logs)
        assert "resumed from step 2" in logs[0]
    assert sorted(os.listdir(tmp_path / "orbax")) == [
        f"lm_dcp_global_n{world}", f"lm_out_p0_n{world}.csv",
        f"lm_out_p1_n{world}.csv"]
    from torch_ckpt_sets import dcp_tensors

    got = dcp_tensors(tmp_path / "orbax" / f"lm_dcp_global_n{world}" / "4")
    for r in range(world):
        state, meta = _file(tmp_path / "msgpack", r, world)
        assert meta["step"] == 4
        for n, t in state["params"].items():
            assert torch.equal(got[f"state.params.{n}"][r], t), (r, n)
        for n, t in state["opt_state"].items():
            assert torch.equal(got[f"state.opt_state.{n}"][r], t), (r, n)
    # the two processes' momentum rows differ (at world 2 a round
    # averages the params exactly), so each kept its own
    assert not torch.equal(got["state.opt_state.embed.weight"][0],
                           got["state.opt_state.embed.weight"][1])
    assert _rows(tmp_path / "orbax" / f"lm_out_p0_n{world}.csv") == _rows(
        tmp_path / "msgpack" / f"lm_out_p0_n{world}.csv")


# -- --sp > 1 under torchrun: one sequence shard a process -------------------

SP_CASES = {"dp2_sp2": ["--sp", "2", "--attn", "ring_flash", "--remat",
                        "True"],
            "dp1_sp4": ["--sp", "4", "--attn", "ring"]}


def _shard_files(directory, dp, sp, world):
    return {(r, i): os.path.join(
        directory, f"lm_checkpoint_r{r}_s{i}_n{world}.ckpt")
        for r in range(dp) for i in range(sp)}


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_sp_under_torchrun_rows_equal_the_stacked_run(tmp_path, case):
    """4 processes, each one sequence shard: every process's CSV rows equal
    the stacked run's outside timing, and its checkpoint file (named by
    replica and shard) holds its replica's state, the same in every shard
    of the replica and the stacked file's push-sum weight."""
    world, sp = 4, int(SP_CASES[case][1])
    dp, n = world // sp, 4
    dist, stacked = str(tmp_path / "dist"), str(tmp_path / "stacked")
    argv = SMALL + SP_CASES[case] + ["--num_steps", str(n)]
    codes, logs = _join(_spawn(argv + ["--checkpoint_dir", dist], world))
    assert codes == [0] * world, "\n".join(logs)
    assert (f"lm: world {world} = dp {dp} x sp {sp} (process 0: replica 0, "
            "shard 0)") in logs[0]
    _one_thread(lambda: gossip_lm.main(
        argv + ["--world_size", str(world), "--checkpoint_dir", stacked]))
    want = _rows(os.path.join(stacked, f"lm_out_n{world}.csv"))
    assert len(want) == n
    for p in range(world):
        assert _rows(os.path.join(dist, f"lm_out_p{p}_n{world}.csv")) == want
    files = _shard_files(dist, dp, sp, world)
    for (r, i), path in files.items():
        got = _flat(torch.load(path, weights_only=True)["state"])
        first = _flat(torch.load(files[r, 0], weights_only=True)["state"])
        ref = _flat(_file(stacked, r, world)[0])
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert torch.equal(got[key], first[key]), (r, i, key)
        assert torch.equal(got["/gossip/ps_weight"],
                           ref["/gossip/ps_weight"])
        for key in ref:
            torch.testing.assert_close(got[key], ref[key], rtol=0,
                                       atol=2e-6)


def test_sp_torchrun_preemption_and_resume_continue_the_straight_run(
        tmp_path):
    """dp 2 x sp 2 in 4 processes: SIGUSR1 to one makes every process save
    at one step and exit 75; the resume equals a straight run of the same
    processes, rows and files bit for bit."""
    n, world = 150, 4
    cut, straight = str(tmp_path / "cut"), str(tmp_path / "straight")
    argv = SMALL + SP_CASES["dp2_sp2"] + ["--num_steps", str(n)]
    csv = os.path.join(cut, f"lm_out_p0_n{world}.csv")
    procs = _spawn(argv + ["--checkpoint_dir", cut], world)
    codes, logs = _join(procs, signal_to=procs[3],
                        when=lambda: len(_lines(csv)) >= 3)
    assert codes == [75] * world, "\n".join(logs)
    files = _shard_files(cut, 2, 2, world)
    steps = {torch.load(f, weights_only=True)["state"]["step"]
             for f in files.values()}
    assert len(steps) == 1 and 2 <= min(steps) < n, steps
    k = steps.pop()
    codes, logs = _join(_spawn(argv + ["--checkpoint_dir", cut,
                                       "--resume", "True"], world))
    assert codes == [0] * world, "\n".join(logs)
    assert f"resumed from step {k}" in logs[0]
    codes, logs = _join(_spawn(argv + ["--checkpoint_dir", straight],
                               world))
    assert codes == [0] * world, "\n".join(logs)
    for p in range(world):
        got = _rows(os.path.join(cut, f"lm_out_p{p}_n{world}.csv"))
        assert len(got) == n
        assert got == _rows(os.path.join(straight,
                                         f"lm_out_p{p}_n{world}.csv"))
    for key, path in _shard_files(straight, 2, 2, world).items():
        ref = _flat(torch.load(path, weights_only=True)["state"])
        got = _flat(torch.load(files[key], weights_only=True)["state"])
        assert sorted(got) == sorted(ref)
        for name in ref:
            assert torch.equal(got[name], ref[name]), (key, name)


def test_sp_torn_save_window_starts_every_process_at_step_0(tmp_path):
    world = 4
    argv = SMALL + SP_CASES["dp2_sp2"] + ["--checkpoint_dir", str(tmp_path)]
    codes, logs = _join(_spawn(argv + ["--num_steps", "2"], world))
    assert codes == [0] * world, "\n".join(logs)
    os.remove(_shard_files(tmp_path, 2, 2, world)[1, 0])
    codes, logs = _join(_spawn(argv + ["--num_steps", "3", "--resume",
                                       "True"], world))
    assert codes == [0] * world, "\n".join(logs)
    assert "checkpoint present here but missing on a peer; starting from " \
        "step 0" in logs[0]
    assert "no checkpoint for rank 2" in logs[2]
    assert not any("resumed from step" in log for log in logs)
    for p in range(world):
        assert [r[0] for r in _rows(tmp_path / f"lm_out_p{p}_n{world}.csv")
                ] == ["1", "2", "3"]
    assert all(torch.load(f, weights_only=True)["state"]["step"] == 3
               for f in _shard_files(tmp_path, 2, 2, world).values())


def test_sp_cross_world_resume_under_torchrun_is_refused_by_name(tmp_path):
    argv = SMALL + ["--checkpoint_dir", str(tmp_path), "--num_steps", "1",
                    "--sp", "2"]
    codes, logs = _join(_spawn(argv + ["--world_size", "2"]))
    assert codes == [0], logs[0]
    codes, logs = _join(_spawn(argv + ["--resume", "True"], 4))
    assert all(c != 0 for c in codes), "\n".join(logs)
    for log in logs:
        assert ("NotImplementedError: cross-world resume" in log
                and "the run spans 4 processes" in log), log
