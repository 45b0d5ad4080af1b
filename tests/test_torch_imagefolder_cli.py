"""The image CLIs on an ImageFolder tree on the CPU (``--dataset
imagefolder``), with the flags this tree streams, prefetches, averages
asynchronously, profiles and checkpoints with.

* ``run/gossip_sgd.py`` on ``tiny_cnn`` at world 4 stacked over a JPEG
  tree written here: two epochs straight (with ``--prefetch True``)
  equal one epoch, then ``--resume True`` to two (without prefetch),
  every rank file's tensors exactly;
* ``--data_output uint8`` (normalised in the step) against ``f32``
  (normalised on the host): the first step's per-rank losses within
  ``LOSS_RTOL`` (the two normalisations round differently, by an ulp);
* ``--data_backend native`` refused by name; ``auto`` and ``pil`` both
  decode with PIL, named in the log line;
* ``run/gossip_sgd_adpsgd.py --bilat_async True`` on the stacked lane:
  a staleness summary in the result, adoptions made;
* ``--checkpoint_all False``: rank 0's file alone, and a resume starts
  every rank from rank 0's row;
* ``--profile_dir``: a Chrome trace of the window; the window knobs
  without a directory, and a negative ``--heartbeat_timeout``, refused;
* under a torchrun environment (``tests/test_torch_dist_trainer.py``'s),
  the imagefolder run at world 2 in 2 processes equals the stacked
  world-2 run rank file for rank file, ``--prefetch True`` warns and
  goes on without; ``--bilat_async True`` and ``--checkpoint_all False``
  are refused (single-process only).
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.run import gossip_sgd, gossip_sgd_adpsgd
from stochastic_gradient_push_torch.train import loop as tloop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# uint8 normalised in the step vs float32 normalised on the host: inputs
# an ulp apart, the first step's loss to this relative tolerance
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 8), ("val", 4)):
        for c in range(4):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(per_class):
                px = rng.integers(0, 256, (20, 26, 3)).astype(np.uint8)
                px[..., c % 3] = 60 * (c + 1)
                Image.fromarray(px).save(d / f"img_{i}.jpg", quality=90)
    return root


def _argv(tree, ckpt, *extra):
    return ["--device", "cpu", "--dataset", "imagefolder", "--dataset_dir",
            str(tree), "--model", "tiny_cnn", "--image_size", "16",
            "--num_classes", "4", "--batch_size", "2",
            "--num_dataloader_workers", "2", "--num_epochs", "2",
            "--num_itr_ignore", "0", "--print_freq", "1", "--verbose",
            "False", "--checkpoint_dir", str(ckpt), *extra]


def _stacked(tree, ckpt, *extra):
    return _argv(tree, ckpt, "--world_size", str(WORLD), *extra)


def _rank_file(directory, r, world=WORLD):
    return torch.load(os.path.join(directory, f"checkpoint_r{r}_n{world}.ckpt"),
                      weights_only=True)


def _tensors(tree, prefix=""):
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


def test_imagefolder_runs_and_resume_equals_continue(tree, tmp_path, capsys):
    straight = tmp_path / "straight"
    result = gossip_sgd.main(_stacked(tree, straight, "--prefetch", "True",
                                      "--verbose", "True"))
    out = capsys.readouterr().out
    assert "32 train and 16 val images, 4 classes; decoding with PIL" in out
    assert "--data_backend auto: the native decoder is not ported" in out
    assert 0.0 <= result["best_prec1"] <= 100.0
    split = tmp_path / "split"
    gossip_sgd.main(_stacked(tree, split, "--num_epochs", "1"))
    gossip_sgd.main(_stacked(tree, split, "--resume", "True"))
    with open(straight / f"out_r0_n{WORLD}.csv") as f:
        rows = [r.split(",") for r in f.read().splitlines()[5:]]
    # 32 images over 4 ranks, 2 a batch: 4 steps an epoch
    assert [r[:2] for r in rows if r[1] == "-1"] == [["0", "-1"],
                                                     ["1", "-1"]]
    assert len(rows) == 2 * (4 + 2)
    for r in range(WORLD):
        want = _tensors(_rank_file(straight, r)["state"])
        got = _tensors(_rank_file(split, r)["state"])
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


def _first_losses(monkeypatch, argv) -> np.ndarray:
    """The first step's per-rank losses: the first read of a step's
    metrics rows (``loop.to_host``)."""
    seen = []
    real = tloop.to_host

    def spy(x, transport):
        out = real(x, transport)
        seen.append(np.array(out))
        return out

    monkeypatch.setattr(tloop, "to_host", spy)
    gossip_sgd.main(argv)
    monkeypatch.setattr(tloop, "to_host", real)
    return seen[0][:, 0]


def test_uint8_and_f32_first_step_losses_agree(tree, tmp_path, monkeypatch):
    one = ("--num_epochs", "1", "--num_iterations_per_training_epoch", "1")
    f32 = _first_losses(monkeypatch, _stacked(tree, tmp_path / "f", *one))
    u8 = _first_losses(monkeypatch, _stacked(
        tree, tmp_path / "u", *one, "--data_output", "uint8",
        "--data_backend", "pil"))
    assert f32.shape == (WORLD,) and np.isfinite(f32).all()
    np.testing.assert_allclose(u8, f32, rtol=LOSS_RTOL, atol=0)


def test_native_backend_is_refused_by_name(tree, tmp_path):
    with pytest.raises(SystemExit, match="--data_backend native: .*"
                                         "jpeglib.h"):
        gossip_sgd.main(_stacked(tree, tmp_path, "--data_backend",
                                 "native"))


def test_bilat_async_runs_on_the_stacked_lane(tree, tmp_path):
    result = gossip_sgd_adpsgd.main(_stacked(
        tree, tmp_path, "--bilat_async", "True", "--num_epochs", "1"))
    stats = result["async_bilat"]
    assert stats["adoptions"] >= 1 and stats["rounds"] >= stats["adoptions"]
    assert stats["staleness_max"] >= 0
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("checkpoint_r")]) == WORLD


def test_checkpoint_all_false_keeps_rank_0_and_resumes_every_rank(
        tree, tmp_path):
    gossip_sgd.main(_stacked(tree, tmp_path, "--num_epochs", "1",
                             "--checkpoint_all", "False"))
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt")) \
        == [f"checkpoint_r0_n{WORLD}.ckpt", f"model_best_r0_n{WORLD}.ckpt"]
    saved = _tensors(_rank_file(tmp_path, 0)["state"]["params"])
    handlers = {s: signal.getsignal(s) for s in (signal.SIGUSR1,
                                                 signal.SIGTERM)}
    try:
        run = gossip_sgd.build(_stacked(tree, tmp_path, "--resume", "True",
                                        "--checkpoint_all", "False"))
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    state, meta = run.trainer.cluster.ckpt.restore(run.trainer.init_state())
    assert meta["epoch"] == 1
    for k, t in state.params.items():
        for r in range(WORLD):
            assert torch.equal(t[r], saved[f"/{k}"]), (k, r)


def test_profile_window_writes_a_trace(tree, tmp_path):
    result = gossip_sgd.main(_stacked(
        tree, tmp_path / "c", "--num_epochs", "1", "--profile_dir",
        str(tmp_path / "prof"), "--profile_start_step", "1",
        "--profile_steps", "2"))
    assert result["profile_trace"] == str(tmp_path / "prof" /
                                          "trace_r0_steps1-2.json")
    with open(result["profile_trace"]) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("argv,match", [
    (["--profile_steps", "2"], "need --profile_dir"),
    (["--profile_dir", "p", "--profile_steps", "0"], "profile_steps must"),
    (["--profile_dir", "p", "--profile_start_step", "-1"],
     "profile_start_step must"),
    (["--heartbeat_timeout", "-1"], "heartbeat_timeout must"),
])
def test_profile_and_heartbeat_flags_are_validated(tree, tmp_path, argv,
                                                   match):
    with pytest.raises(SystemExit, match=match):
        gossip_sgd.main(_stacked(tree, tmp_path, *argv))


def test_flags_reach_the_trainer_config(tree, tmp_path):
    cfg, _ = gossip_sgd.parse_config(_stacked(
        tree, tmp_path, "--prefetch", "True", "--heartbeat_timeout", "0",
        "--checkpoint_all", "False", "--profile_dir", "p"))
    assert (cfg.prefetch, cfg.heartbeat_timeout, cfg.checkpoint_all,
            cfg.profile_dir, cfg.profile_start_step, cfg.profile_steps) == (
        True, 0, False, "p", 2, 3)


def _torchrun_env(rank, world, port):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


@pytest.mark.parametrize("module,flags,match", [
    (gossip_sgd_adpsgd, ["--bilat_async", "True"], "single-process only"),
    (gossip_sgd, ["--checkpoint_all", "False"], "single-process only"),
])
def test_single_process_flags_are_refused_under_torchrun(
        tree, tmp_path, monkeypatch, module, flags, match):
    for k, v in _torchrun_env(0, 2, 1).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=f"{flags[0]} .*{match}"):
        module.main(_argv(tree, tmp_path, *flags))


@pytest.mark.parametrize("field,value", [("bilat_async", True),
                                         ("checkpoint_all", False)])
def test_single_process_rule_is_the_trainers(field, value):
    # the one rule both the Trainer (a world spread over processes) and
    # the CLIs (before the process group) apply
    tloop.refuse_single_process_only(tloop.TrainerConfig())
    with pytest.raises(ValueError,
                       match=f"^{field} {value} is single-process only"):
        tloop.refuse_single_process_only(
            tloop.TrainerConfig(**{field: value}))


def test_imagefolder_under_torchrun_equals_the_stacked_run(tree, tmp_path):
    world = 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = _argv(tree, tmp_path / "dist", "--num_epochs", "1",
                 "--num_iterations_per_training_epoch", "3",
                 "--prefetch", "True", "--verbose", "True")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stochastic_gradient_push_torch.run."
         "gossip_sgd", *argv], env=_torchrun_env(r, world, port), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    # the reference's warning (train/loop.py:975-979 there)
    assert all("prefetch supports single-process non-scanned runs only"
               in log for log in logs)
    # the children's one thread (a CPU convolution's sums follow the
    # thread count, and other test files set their own at import)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gossip_sgd.main(_argv(tree, tmp_path / "stacked", "--num_epochs",
                              "1", "--num_iterations_per_training_epoch",
                              "3", "--world_size", str(world)))
    finally:
        torch.set_num_threads(threads)
    for r in range(world):
        got = _tensors(_rank_file(tmp_path / "dist", r, world)["state"])
        want = _tensors(_rank_file(tmp_path / "stacked", r, world)["state"])
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)
