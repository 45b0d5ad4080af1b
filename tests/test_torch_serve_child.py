"""The port's decode-fleet child (``serve/child.py``) against the
reference's (``stochastic_gradient_push_tpu/serve/child.py``).

The same seed and rows give the same served summary (requests, tokens,
rejections, decode steps, peak page occupancy: everything but the
clock's) and the same checkpoint rows, exactly, across the two file
formats: on a cold start (no set on disk) and on the consensus of a
host-sim set.  The rows are the consensus replicated with ps-weight 1,
so a reshard of them is exact.  SIGUSR1 drains to exit 75 with a save;
a torn set falls back to the cold model.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.serve import child as tchild
from stochastic_gradient_push_torch.supervise import hostsim as tsim
from stochastic_gradient_push_torch.supervise import reshard as port
from stochastic_gradient_push_tpu.serve import child as rchild
from stochastic_gradient_push_tpu.supervise import hostsim as rsim

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = {"elapsed_s", "tokens_per_sec", "p50_latency_s", "p99_latency_s"}


def _argv(d, steps=12, seed=0, world=4):
    """One host holding every row of ``world``."""
    rows = world
    return ["--checkpoint_dir", d, "--trace_dir", os.path.join(d, "serve"),
            "--world_size", str(world), "--num_processes", "1",
            "--process_id", "0", "--rows", str(rows), "--steps", str(steps),
            "--save_every", "5", "--step_s", "0", "--seed", str(seed)]


def _summary(d):
    evs = [json.loads(x) for x in open(os.path.join(d, "serve",
                                                    "events.jsonl"))]
    meta = [e["data"] for e in evs if e["kind"] == "run_meta"][0]
    s = [e["data"] for e in evs if e["kind"] == "serve"
         and e["data"].get("phase") == "summary"][0]
    ticks = [e["data"] for e in evs if e["kind"] == "step_stats"]
    return ({k: v for k, v in s.items() if k not in CLOCK},
            meta["model_source"], ticks)


def _ref_file(d, world):
    import flax.serialization

    with open(os.path.join(d, f"checkpoint_r0_n{world}.ckpt"), "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def _host_sim_sets(dp, dr):
    """The same world-4 host-sim set in the two formats."""
    for p in range(2):
        argv = ["--world_size", "4", "--num_processes", "1",
                "--process_id", "0", "--rows", "2", "--rank_offset",
                str(2 * p), "--steps", "7", "--save_every", "7",
                "--step_s", "0", "--seed", "4"]
        assert tsim.main(["--checkpoint_dir", dp, "--trace_dir",
                          os.path.join(dp, f"h{p}")] + argv) == 0
        if p == 0:
            assert rsim.main(["--checkpoint_dir", dr, "--trace_dir",
                              os.path.join(dr, "h0")]
                             + argv[:6] + ["--rows", "4"] + argv[8:]) == 0


@pytest.mark.parametrize("source", ["cold", "host-sim"])
@pytest.mark.parametrize("seed", [0, 3])
def test_served_summary_and_rows_are_the_references(tmp_path, source, seed):
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(dp)
    os.makedirs(dr)
    if source == "host-sim":
        _host_sim_sets(dp, dr)
    world = 2 if source == "host-sim" else 4   # a set of another world
    assert tchild.main(_argv(dp, seed=seed, world=world)) == 0
    assert rchild.main(_argv(dr, seed=seed, world=world)) == 0
    got, want = _summary(dp), _summary(dr)
    assert got == want
    assert want[0]["requests"] > 0
    assert want[1] == ("cold" if source == "cold" else "consensus_n4")
    raw = _ref_file(dr, world)
    state, meta, files = port.load_world_checkpoint(dp, "", world)
    assert len(files) == world and meta == raw["meta"]
    assert np.array_equal(state["params"]["w"],
                          np.asarray(raw["state"]["params"]["w"]))
    assert np.array_equal(state["gossip"]["ps_weight"],
                          np.ones(world, np.float32))
    # identical replicas collapse to themselves
    rows = np.asarray(state["params"]["w"])
    assert all(np.array_equal(rows[0], r) for r in rows)
    assert np.array_equal(port.consensus_mean(state)["w"].astype(np.float32),
                          rows[0])


def test_a_torn_set_serves_the_cold_model(tmp_path):
    d = str(tmp_path)
    for p in range(2):
        assert tsim.main(["--checkpoint_dir", d, "--trace_dir",
                          os.path.join(d, f"h{p}"), "--world_size", "4",
                          "--num_processes", "1", "--process_id", "0",
                          "--rows", "2", "--rank_offset", str(2 * p),
                          "--steps", str(3 + p), "--step_s", "0"]) == 0
    with pytest.raises(port.TornCheckpointError, match="different saves"):
        port.load_world_checkpoint(d, "", 4)
    assert tchild.main(_argv(d, world=2)) == 0
    assert _summary(d)[1] == "cold"


def test_sigusr1_drains_to_75_with_a_save(tmp_path):
    d = str(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    child = subprocess.Popen(
        [sys.executable, "-m", "stochastic_gradient_push_torch.serve.child",
         *_argv(d, steps=5000)[:-4], "--step_s", "0.01"], env=env)
    ev = os.path.join(d, "serve", "events.jsonl")
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not (
                os.path.isfile(ev) and os.path.getsize(ev) > 600):
            time.sleep(0.05)
        child.send_signal(signal.SIGUSR1)
        assert child.wait(timeout=30) == 75
    finally:
        child.kill()
    evs = [json.loads(x) for x in open(ev)]
    exits = [e["data"] for e in evs if e["kind"] == "run_meta"
             and "exit_reason" in e["data"]]
    assert exits[-1]["exit_reason"] == "preempted"
    assert evs[-1]["kind"] == "serve"
    _, meta, _ = port.load_world_checkpoint(d, "", 4)
    assert meta["step"] == exits[-1]["step"] > 0
