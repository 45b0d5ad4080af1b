"""The port's host-sim trainer (``supervise/hostsim.py``), its world
barrier, the concurrent shard reshard, and one coordinated fleet cycle
of host-sim children, on the CPU.

* The same argv (seed, rows, rank offset, steps) gives the reference's
  rows, bit for bit, across the two file formats (its one msgpack file
  a host, the port's ``torch.save`` file a rank), straight and resumed.
* ``--resume`` with a host's files partly missing exits 2 (the
  reference's rows check); SIGUSR1 drains to exit 75 with a save.
* Two hosts of one world save in step; SIGKILL of one leaves the set at
  one save (never torn), and the survivor, waiting on the dead peer,
  drains to 75 without a save.
* Survivors reshard disjoint rank ranges concurrently (two processes)
  into one set that is not torn, equal to the reference's
  ``reshard_state`` of the same rows; a missing or mixed rank file makes
  it torn.
* ``scripts/torch_fleet.py --selftest``'s cycle at a small size: 3 hosts
  x 2 rows, host 2 SIGKILLed whole, the deadline-missed round re-run at
  2 hosts, one assign -> go, the run completes at world 4, the mean kept
  to 1e-5.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.supervise import hostsim as tsim
from stochastic_gradient_push_torch.supervise import reshard as port
from stochastic_gradient_push_tpu.supervise import hostsim as rsim
from stochastic_gradient_push_tpu.supervise import reshard as ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _ref_rows(d, proc, world):
    import flax.serialization

    with open(os.path.join(d, f"checkpoint_r{proc}_n{world}.ckpt"),
              "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    return raw["state"], raw["meta"]


def _port_rows(d, ranks, world):
    rows = [torch.load(os.path.join(d, f"checkpoint_r{r}_n{world}.ckpt"),
                       weights_only=True) for r in ranks]
    state = {"w": np.stack([r["state"]["params"]["w"].numpy() for r in rows]),
             "ps_weight": np.array([float(r["state"]["gossip"]["ps_weight"])
                                    for r in rows], np.float32),
             "phase": np.array([r["state"]["gossip"]["phase"]
                                for r in rows], np.int32)}
    metas = [json.loads(r["meta"]) for r in rows]
    assert all(m == metas[0] for m in metas)
    return state, metas[0]


def _argv(d, rows, offset, steps, *extra, world=6, seed=0):
    return ["--checkpoint_dir", d, "--trace_dir", os.path.join(d, "h"),
            "--world_size", str(world), "--num_processes", "1",
            "--process_id", "0", "--rows", str(rows), "--rank_offset",
            str(offset), "--steps", str(steps), "--save_every", "4",
            "--step_s", "0", "--seed", str(seed), *extra]


@pytest.mark.parametrize("rows,offset,steps,seed", [
    (2, 0, 6, 0), (3, 3, 9, 5), (1, 4, 4, 2)])
def test_rows_are_the_references_across_the_formats(tmp_path, rows, offset,
                                                     steps, seed):
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    assert tsim.main(_argv(dp, rows, offset, steps, seed=seed)) == 0
    assert rsim.main(_argv(dr, rows, offset, steps, seed=seed)) == 0
    got, gmeta = _port_rows(dp, range(offset, offset + rows), 6)
    want, wmeta = _ref_rows(dr, 0, 6)
    assert np.array_equal(got["w"], np.asarray(want["params"]["w"]))
    assert np.array_equal(got["ps_weight"],
                          np.asarray(want["gossip"]["ps_weight"]))
    assert np.array_equal(got["phase"], np.asarray(want["gossip"]["phase"]))
    assert gmeta == wmeta
    # resumed to twice the steps: the reference's rows again
    assert tsim.main(_argv(dp, rows, offset, 2 * steps, "--resume",
                           "True", seed=seed)) == 0
    assert rsim.main(_argv(dr, rows, offset, 2 * steps, "--resume",
                           "True", seed=seed)) == 0
    got, gmeta = _port_rows(dp, range(offset, offset + rows), 6)
    want, wmeta = _ref_rows(dr, 0, 6)
    assert np.array_equal(got["w"], np.asarray(want["params"]["w"]))
    assert gmeta["step"] == wmeta["step"] == 2 * steps
    evs = [json.loads(x) for x in open(os.path.join(dp, "h",
                                                    "events.jsonl"))]
    assert [e["kind"] for e in evs].count("run_meta") == 4
    assert evs[-1]["data"]["exit_reason"] == "complete"


def test_resume_with_a_hosts_files_partly_missing_exits_2(tmp_path, capsys):
    d = str(tmp_path)
    assert tsim.main(_argv(d, 2, 0, 2)) == 0
    assert tsim.main(_argv(d, 3, 0, 4, "--resume", "True")) == 2
    assert "holds rows [0, 1] of this host's 3" in capsys.readouterr().err
    assert tsim.main(_argv(d, 7, 0, 4)) == 2


def _spawn(d, proc, nproc, rows, world, steps=2000, step_s="0.01"):
    return subprocess.Popen(
        [sys.executable, "-m", "stochastic_gradient_push_torch.supervise."
         "hostsim", "--checkpoint_dir", d, "--trace_dir",
         os.path.join(d, f"h{proc}"), "--world_size", str(world),
         "--num_processes", str(nproc), "--process_id", str(proc),
         "--rows", str(rows), "--steps", str(steps), "--save_every", "3",
         "--step_s", step_s], env=ENV)


def _wait_for(pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_sigusr1_alone_drains_to_75_with_a_save(tmp_path):
    d = str(tmp_path)
    child = _spawn(d, 0, 1, 2, 4)
    try:
        ev = os.path.join(d, "h0", "events.jsonl")
        assert _wait_for(lambda: os.path.isfile(ev)
                         and os.path.getsize(ev) > 400)
        child.send_signal(signal.SIGUSR1)
        assert child.wait(timeout=30) == 75
    finally:
        child.kill()
    _, meta = _port_rows(d, [0, 1], 4)
    evs = [json.loads(x) for x in open(ev)]
    last = evs[-1]["data"]
    assert last["exit_reason"] == "preempted" and last["exit_code"] == 75
    assert 0 < meta["step"] == last["step"] < 2000


def test_a_killed_host_leaves_the_world_at_one_save(tmp_path):
    d = str(tmp_path)
    hosts = [_spawn(d, p, 2, 2, 4) for p in range(2)]
    try:
        files = [os.path.join(d, f"checkpoint_r{r}_n4.ckpt") for r in range(4)]
        assert _wait_for(lambda: all(os.path.isfile(f) for f in files))
        time.sleep(0.3)
        hosts[1].kill()
        hosts[1].wait()
        # the survivor stops at the next save, waiting on its dead peer
        ev = os.path.join(d, "h0", "events.jsonl")

        def quiet():
            now = os.path.getsize(ev)
            time.sleep(0.3)
            return os.path.getsize(ev) == now

        assert _wait_for(quiet, 20)
        state, meta, _ = port.load_world_checkpoint(d, "", 4)
        step = meta["step"]
        assert step % 3 == 0 and list(state["step"]) == [step] * 4
        hosts[0].send_signal(signal.SIGUSR1)
        assert hosts[0].wait(timeout=30) == 75
        _, meta, _ = port.load_world_checkpoint(d, "", 4)
        assert meta["step"] == step     # no save on the drain
    finally:
        for h in hosts:
            h.kill()
            h.wait()


_RESHARD = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    from stochastic_gradient_push_torch.supervise.reshard import (
        reshard_checkpoints)
    d, lo, hi = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    reshard_checkpoints(d, "", 6, 4, ranks=range(lo, hi))
""")


def test_survivors_reshard_disjoint_ranks_into_one_set(tmp_path):
    d = str(tmp_path)
    for p in range(3):
        assert tsim.main(["--checkpoint_dir", d, "--trace_dir",
                          os.path.join(d, f"h{p}"), "--world_size", "6",
                          "--num_processes", "1", "--process_id", "0",
                          "--rows", "2", "--rank_offset", str(2 * p),
                          "--steps", "4", "--save_every", "4",
                          "--step_s", "0", "--seed", "3"]) == 0
    old, _, _ = port.load_world_checkpoint(d, "", 6)
    procs = [subprocess.Popen([sys.executable, "-c", _RESHARD, REPO, d,
                               str(lo), str(lo + 2)], env=ENV)
             for lo in (0, 2)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    new, meta, files = port.load_world_checkpoint(d, "", 4)
    assert len(files) == 4 and meta["reshard"]["old_world"] == 6
    want = ref.reshard_state(
        {"params": old["params"], "gossip": old["gossip"],
         "step": old["step"]}, 6, 4)
    assert np.array_equal(new["params"]["w"], want["params"]["w"])
    assert np.array_equal(new["gossip"]["ps_weight"],
                          want["gossip"]["ps_weight"])
    m_old, m_new = port.consensus_mean(old), port.consensus_mean(new)
    assert float(np.abs(m_old["w"] - m_new["w"]).max()) < 1e-6
    # a missing rank file, or one of another save, is torn
    keep = open(files[3], "rb").read()
    os.remove(files[3])
    with pytest.raises(port.TornCheckpointError, match="want 0..3"):
        port.load_world_checkpoint(d, "", 4)
    blob = torch.load(files[2], weights_only=True)
    blob["state"]["step"] = 9
    with open(files[3], "wb") as f:
        f.write(keep)
    torch.save(blob, files[2])
    with pytest.raises(port.TornCheckpointError, match="r2 step 9"):
        port.load_world_checkpoint(d, "", 4)


def test_one_coordinated_fleet_cycle_of_host_sim_children(tmp_path, capsys):
    from stochastic_gradient_push_torch.supervise.fleetcli import selftest

    rc = selftest(keep_dir=str(tmp_path), steps=40, step_s=0.03,
                  child_env=ENV)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    assert "fleet selftest: OK (3x2-rank fleet, host 2 slice SIGKILLed" \
        in out.out
    evs = [json.loads(x) for x in open(tmp_path / "coordinator.jsonl")]
    phases = [e["data"]["phase"] for e in evs]
    assert phases.count("assign") == phases.count("go") == 1
    assert phases[-1] == "complete"
