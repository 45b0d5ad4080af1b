"""The supervisor over the port's real command lines, and their fleet
flags, on the CPU.

* One supervised cycle of ``python -m stochastic_gradient_push_torch.
  run.gossip_sgd --device cpu`` (``tiny_cnn``, stacked world 4): the
  child is SIGKILLed after its first whole checkpoint set, the
  supervisor reshards 4 -> 2, replans and relaunches, and the run
  completes (``supervise/cli.py::selftest`` at world 4, its checks: one
  relaunch, a plan stamped at world 2, the final set at world 2).  The
  boundary: the consensus of the new set equals the reference's
  ``consensus_mean`` of the old set's arrays within 1e-5.
* ``scripts/torch_supervise.py``'s refusals (exit 2).
* ``--fleet``/``--host_id`` in both CLIs and the Trainer, as the
  reference's ``TestRunCLIFleetKnobs``: ``--host_id`` needs ``--fleet
  True``, ``--fleet True`` needs ``--trace_dir``; a fleet run stamps
  ``fleet``/``host_id`` into ``run_meta``, and its resume leaves a set of
  another world to the pod coordinator (no reshard); a one-host fleet
  (``scripts/torch_fleet.py``, coordinator and host supervisor) over the
  CLI survives its child's SIGKILL through one coordinated cycle.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.run import gossip_lm, gossip_sgd
from stochastic_gradient_push_torch.supervise import reshard as port
from stochastic_gradient_push_tpu.supervise import reshard as ref
from torch_ckpt_sets import from_port

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SGD = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
       "--image_size", "8", "--num_classes", "4", "--batch_size", "4",
       "--num_epochs", "1", "--num_iterations_per_training_epoch", "2",
       "--num_itr_ignore", "0", "--print_freq", "1", "--verbose", "False"]
LM = ["--device", "cpu", "--vocab_size", "64", "--d_model", "16",
      "--n_layers", "1", "--n_heads", "1", "--d_ff", "32", "--seq_len",
      "16", "--batch_size", "2", "--num_steps", "2", "--print_freq", "1",
      "--corpus_tokens", "2000"]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_one_supervised_cycle_of_the_image_cli(tmp_path, capsys):
    from stochastic_gradient_push_torch.supervise.cli import selftest

    seen = {}

    def on_boundary(old, new):
        want = ref.consensus_mean(from_port(old))
        got = port.consensus_mean(new)
        seen["drift"] = max(
            float(np.abs(got[k] - want[k.replace(".", "/")]).max())
            for k in got)
        seen["keys"] = len(got)

    env = dict(os.environ, OMP_NUM_THREADS="1")
    rc = selftest(keep_dir=str(tmp_path), child_env=env, device="cpu",
                  world=4, shrunk=2, num_epochs=8, on_boundary=on_boundary)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    assert "supervise selftest: OK (world 4 child killed" in out.out
    assert seen["keys"] > 0 and seen["drift"] < 1e-5
    sup = _events(tmp_path / "supervisor.jsonl")
    rel = [e["data"] for e in sup if e["kind"] == "relaunch"]
    assert len(rel) == 1 and rel[0]["world"] == 2 \
        and rel[0]["prev_world"] == 4 and rel[0]["mean_drift"] < 1e-5
    # the relaunched generation resumed from the resharded set
    meta = [e["data"] for e in _events(tmp_path / "events.jsonl")
            if e["kind"] == "run_meta" and "world" in e["data"]]
    assert [m["world"] for m in meta] == [4, 2]


@pytest.mark.parametrize("argv,code", [
    ([], 2),                                   # no child command
    (["--", sys.executable, "x.py", "--world_size", "2"], 2),  # no trace
    (["--", sys.executable, "x.py", "--trace_dir", "/t"], 2),  # no world
])
def test_the_supervise_script_refuses_what_it_cannot_run(argv, code):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_supervise.py"),
         *argv], capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stderr


# -- --fleet / --host_id ------------------------------------------------------


def test_sgd_rejects_host_id_without_fleet():
    with pytest.raises(SystemExit, match="needs --fleet True"):
        gossip_sgd.parse_config(SGD + ["--host_id", "2"])


def test_sgd_rejects_fleet_without_trace_dir():
    with pytest.raises(SystemExit, match="needs --trace_dir"):
        gossip_sgd.parse_config(SGD + ["--fleet", "True"])


def test_sgd_fleet_lands_in_config(tmp_path):
    cfg, args = gossip_sgd.parse_config(
        SGD + ["--fleet", "True", "--host_id", "1", "--trace_dir",
               str(tmp_path)])
    assert cfg.fleet is True and cfg.host_id == 1 and args.fleet is True
    cfg, _ = gossip_sgd.parse_config(SGD)
    assert cfg.fleet is False and cfg.host_id is None


def test_lm_rejects_fleet_knob_misuse(tmp_path):
    base = LM + ["--checkpoint_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="needs --fleet True"):
        gossip_lm.main(base + ["--host_id", "1"])
    with pytest.raises(SystemExit, match="needs --trace_dir"):
        gossip_lm.main(base + ["--fleet", "True"])
    # the TPU block rule stays refused by name
    with pytest.raises(SystemExit, match="--attn_block_k 64"):
        gossip_lm.main(base + ["--attn_block_k", "64"])


def test_trainer_fleet_rule_is_the_clis():
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train import loop as tloop
    from stochastic_gradient_push_torch.train.step import make_model

    assert tloop.UNPORTED == {} and gossip_sgd.UNPORTED == {}
    assert set(gossip_lm.UNPORTED) == {"--attn_block_k"}
    for cfg, match in ((tloop.TrainerConfig(host_id=1), "needs fleet=True"),
                       (tloop.TrainerConfig(fleet=True), "needs trace_dir")):
        with pytest.raises(ValueError, match=match):
            tloop.Trainer(cfg, make_model("tiny_cnn"), StackedTransport(2),
                          device="cpu")


@pytest.mark.parametrize("cli", ["sgd", "lm"])
def test_a_fleet_run_stamps_run_meta_and_leaves_the_reshard(tmp_path, cli):
    """World 2 writes a set; the fleet relaunch at world 1 with
    ``--resume True`` neither reshards it nor takes it (the coordinator
    would have written the world-1 files) and starts over, its
    ``run_meta`` stamped ``fleet``/``host_id``.  Without ``--fleet`` the
    same relaunch reshards (the check that the set was usable)."""
    main, base, tag = ((gossip_sgd.main, SGD, "") if cli == "sgd"
                       else (gossip_lm.main, LM, "lm_"))
    ck = str(tmp_path / "ck")
    main(base + ["--world_size", "2", "--checkpoint_dir", ck])
    tel = str(tmp_path / "tel")
    main(base + ["--world_size", "1", "--checkpoint_dir", ck, "--resume",
                 "True", "--fleet", "True", "--host_id", "3",
                 "--trace_dir", tel])
    meta = [e["data"] for e in _events(os.path.join(tel, "events.jsonl"))
            if e["kind"] == "run_meta" and "world" in e["data"]]
    assert meta[0]["fleet"] is True and meta[0]["host_id"] == 3
    _, saved, _ = port.load_world_checkpoint(ck, tag, 1)
    assert "reshard" not in saved   # its own save, no reshard's
    os.remove(os.path.join(ck, f"{tag}checkpoint_r0_n1.ckpt"))
    main(base + ["--world_size", "1", "--checkpoint_dir", ck, "--resume",
                 "True", "--trace_dir", str(tmp_path / "tel2")])
    _, saved, _ = port.load_world_checkpoint(ck, tag, 1)
    assert saved["reshard"]["old_world"] == 2
    meta = [e["data"] for e in _events(
        str(tmp_path / "tel2" / "events.jsonl"))
        if e["kind"] == "run_meta" and "world" in e["data"]]
    assert "fleet" not in meta[0]


def test_a_one_host_fleet_over_the_image_cli(tmp_path):
    """The fleet path over the real CLI: a coordinator and one host's
    supervisor (``scripts/torch_fleet.py``) over ``gossip_sgd --fleet
    True`` stacked at world 4.  The child is SIGKILLed after a whole
    save; the host reports the fault, the rendezvous and assignment run
    (world 4 again: the one host's rows), the host reshards its shard,
    acks and relaunches on ``go`` with ``--resume True``; both exit 0 and
    both generations' ``run_meta`` carry ``fleet``."""
    import signal
    import time

    d = str(tmp_path)
    host = os.path.join(d, "host0")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    fleet = os.path.join(REPO, "scripts", "torch_fleet.py")
    coord = subprocess.Popen(
        [sys.executable, fleet, "--coordinator", "--fleet_dir", d,
         "--hosts", "1", "--rows", "4", "--deadline", "60",
         "--host_timeout", "60", "--poll", "0.05"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sup = subprocess.Popen(
        [sys.executable, fleet, "--host", "0", "--fleet_dir", d, "--rows",
         "4", "--poll", "0.05", "--drain_timeout", "60", "--",
         sys.executable, "-m", "stochastic_gradient_push_torch.run."
         "gossip_sgd", *SGD[:12], "--verbose", "False", "--num_epochs", "30",
         "--num_iterations_per_training_epoch", "2", "--num_itr_ignore",
         "0", "--world_size", "4", "--fleet", "True", "--checkpoint_dir", d,
         "--trace_dir", host], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    files = [os.path.join(d, f"checkpoint_r{r}_n4.ckpt") for r in range(4)]
    try:
        deadline, killed = time.time() + 120, None
        while time.time() < deadline and killed is None:
            time.sleep(0.05)
            pids = [e["data"].get("child_pid") for e in _events(
                os.path.join(host, "supervisor.jsonl"))
                if e["kind"] == "rendezvous"] if os.path.isfile(
                    os.path.join(host, "supervisor.jsonl")) else []
            if not pids or not all(os.path.isfile(f) for f in files):
                continue
            os.kill(pids[-1], signal.SIGSTOP)
            try:
                points = {port.read_save_point(f) for f in files}
            except Exception:   # a rename caught half done
                points = set()
            if len(points) == 1:
                os.kill(pids[-1], signal.SIGKILL)
                killed = points.pop()
            else:
                os.kill(pids[-1], signal.SIGCONT)
        assert killed is not None, "the child never saved a whole set"
        assert sup.wait(timeout=180) == 0, sup.communicate()[0][-3000:]
        assert coord.wait(timeout=60) == 0, coord.communicate()[0][-3000:]
    finally:
        for p in (sup, coord):
            if p.poll() is None:
                p.kill()
                p.wait()
    evs = _events(os.path.join(host, "supervisor.jsonl"))
    rel = [e["data"] for e in evs if e["kind"] == "relaunch"]
    assert len(rel) == 1 and rel[0]["reason"].startswith("fleet-assign")
    assert rel[0]["resharded"] is True and rel[0]["world"] == 4
    phases = [e["data"]["phase"] for e in evs if e["kind"] == "rendezvous"
              and e["data"]["phase"] != "alive"]
    assert phases == ["hello", "fault", "join", "ack", "hello", "done"]
    meta = [e["data"] for e in _events(os.path.join(host, "events.jsonl"))
            if e["kind"] == "run_meta" and "world" in e["data"]]
    assert len(meta) == 2 and all(m["fleet"] is True and m["host_id"] == 0
                                  for m in meta)
    _, final, _ = port.load_world_checkpoint(d, "", 4)
    assert final["epoch"] == 30 and killed[2] < 30
