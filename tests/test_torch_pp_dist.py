"""The pipeline axis across processes (``parallel/pipeline.py::
DistPipe``): one stage a gloo process, held against the stacked lane
(``StackedPipe``, every stage in one process) on the same numpy data, at
world 4 = dp 2 x pp 2.

* Process ``p`` is ``(replica, stage) = (p // pp, p % pp)``, the
  reference's ``make_dp_pp_mesh`` order; its DistPipe and dp transport
  say so, and it holds its stage's ``[1, 1, L/pp, ...]`` slice of every
  stage leaf and the replicated leaves whole.
* The LM step (SGP, SGP on the int8 wire, SGP on the gossip kernel
  lane's twin, OSGP at staleness 2, D-PSGD, AllReduce), two steps and
  the eval step: losses, ``ppl``, grad norms, params, momentum, the
  push-sum weight and the eval loss against the stacked replica's (its
  rows, and of a stage leaf its stage's slice).  Every value a process
  computes is computed by the stack with the same operations on the same
  inputs; the replicated leaves' gradients add a zero from the other
  stage (the all-reduce on the pipe group) and the loss is the last
  stage's cross-entropy plus a zero: bit for bit equal.  A replica's
  stage processes hold bit-equal replicated leaves (each copy gets the
  same summed gradient and gossips on its own dp group), and each
  exchanges ``n_micro + pp - 2`` hand-offs a forward and as many a
  backward.
* The command line under a torchrun environment: every collective
  recorded by its caller (the hand-offs and the sums over stages on the
  ``(replica)`` pipe group, the gossip round and the metric means on the
  stage's dp group, agreement on the world); checkpoints through the DCP
  backend (forced at ``--pp`` > 1, logged), a stage leaf written as its
  logical ``[dp, L, ...]`` rows and a replicated leaf once; a resume from
  the step-2 save to step 3 leaves the same checkpoint, bit for bit, as
  the run that went on; the rows are the stacked ``--world_size 4 --pp
  2`` run's, to their printed digits.

Children run under ``communicate(timeout=...)`` with one torch thread;
this process is pinned to one thread too.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.mesh import make_dp_sp_layout
from stochastic_gradient_push_torch.parallel.pipeline import StackedPipe
from stochastic_gradient_push_torch.run import gossip_lm
import torch_pp_drive as drive
from test_torch_tp_dist import _dcp
from torch_launch import spawn, torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DP, PP = 2, 2
WORLD = DP * PP

_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.parallel.collectives import (
    DistTransport)
from stochastic_gradient_push_torch.parallel.mesh import (
    join_groups, make_dp_sp_layout)
from stochastic_gradient_push_torch.parallel.pipeline import DistPipe
import torch_pp_drive as drive

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
layout = make_dp_sp_layout(world, 1, 1, 1, job["pp"])
groups = join_groups(layout, rank)
transport = DistTransport(group=groups.dp, siblings=layout.all_dp_members())
out = {}
for name in job["algorithms"]:
    pipe = DistPipe(DistTransport(group=groups.pp))
    got = drive.run(name, layout.dp, transport, pipe,
                    drive.batches(layout.dp, 1, 1, job["seed"]))
    out.update({f"{name}/{k}": v for k, v in got.items()})
out["place"] = np.array([*layout.grid(rank), layout.stage(rank),
                         transport.rank, pipe.stages[0]])
np.savez(job["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(job: dict, tmp) -> list[dict]:
    job = dict(job, out=str(tmp / "rank%d.npz"))
    spawn(WORLD, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, TESTS, str(r), str(WORLD),
        str(port), json.dumps(job)], PYTHONPATH=REPO)
    return [dict(np.load(job["out"] % r)) for r in range(WORLD)]


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    torch.set_num_threads(1)
    rows = _spawn({"pp": PP, "seed": 5, "algorithms": list(
        drive.ALGORITHMS)}, tmp_path_factory.mktemp("pp23"))
    want = {}
    for name in drive.ALGORITHMS:
        got = drive.run(name, DP, StackedTransport(DP), StackedPipe(PP),
                        drive.batches(DP, 1, 1, 5))
        want.update({f"{name}/{k}": v for k, v in got.items()})
    return rows, want


def test_processes_sit_on_the_reference_grid(lanes):
    rows, _ = lanes
    layout = make_dp_sp_layout(WORLD, 1, 1, 1, PP)
    for p, row in enumerate(rows):
        replica, s = divmod(p, PP)
        assert layout.grid(p) == (replica, 0, 0, 0)
        # the dp transport's rank is the replica, the DistPipe's stage s
        assert list(row["place"]) == [replica, 0, 0, 0, s, replica, s]
    assert layout.pp_members(1) == [2, 3]
    assert layout.all_dp_members() == [[0, 2], [1, 3]]


def _mine(p, key, stacked):
    """The stacked run's rows of process ``p``: its replica's, and of a
    stage leaf its stage's slice."""
    replica, s = divmod(p, PP)
    w = stacked[replica:replica + 1]
    name = key.split("/", 2)[-1]
    if key.split("/")[1] in ("params", "momentum") and \
            name.startswith("stack."):
        w = w[:, s:s + 1]
    return w


@pytest.mark.parametrize("name", drive.ALGORITHMS)
def test_lm_step_against_the_stack(lanes, name):
    rows, want = lanes
    keys = [k for k in want if k.startswith(name + "/")
            and k != f"{name}/hand_offs"]
    for p, row in enumerate(rows):
        replica, s = divmod(p, PP)
        if s:
            # the replicated state is the same on a replica's stages
            for k in keys:
                part, leaf = k.split("/")[1], k.split("/")[-1]
                if part in ("params", "momentum") and \
                        not leaf.startswith("stack."):
                    np.testing.assert_array_equal(row[k], rows[p - s][k],
                                                  err_msg=k)
        # n_micro + pp - 2 hand-offs a forward, as many a backward, two
        # steps and the eval's forward
        ticks = drive.N_MICRO + PP - 2
        assert int(row[f"{name}/hand_offs"]) == 2 * ticks * drive.STEPS \
            + ticks
        for k in keys:
            w, g = _mine(p, k, want[k]), row[k]
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- the command line: groups, the CSV and the DCP backend ---------------

_CLI_WORKER = r"""
import json, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = ("_exchange", "sum_stages", "mean", "any_process",
       "consensus_resume_point", "pre_step", "post_step")
calls = []

def members(group):
    return dist.get_process_group_ranks(group or dist.group.WORLD)

def who():
    for frame in reversed(traceback.extract_stack()[:-2]):
        if frame.name in WHO:
            return frame.name
    return "?"

def spy(name, fn, group_of):
    def wrapped(*a, **k):
        calls.append([name, who(), members(group_of(a, k))])
        return fn(*a, **k)
    return wrapped

dist.all_reduce = spy("all_reduce", dist.all_reduce,
                      lambda a, k: k.get("group"))
dist.all_gather = spy("all_gather", dist.all_gather,
                      lambda a, k: k.get("group"))
dist.batch_isend_irecv = spy("batch_isend_irecv", dist.batch_isend_irecv,
                             lambda a, k: a[0][0].group)
from stochastic_gradient_push_torch.run import gossip_lm
try:
    gossip_lm.main(json.loads(sys.argv[2]))
finally:
    print("CALLS " + json.dumps(calls), flush=True)
"""

ARGV = ["--device", "cpu", "--pp", str(PP), "--n_micro", "2",
        "--vocab_size", "64", "--d_model", "32", "--n_layers", "4",
        "--n_heads", "4", "--d_ff", "64", "--seq_len", "16",
        "--batch_size", "4", "--print_freq", "1", "--corpus_tokens", "2000",
        "--ckpt_every", "2"]


def _cli(argv: list) -> list[str]:
    return torchrun(WORLD, lambda r: [sys.executable, "-c", _CLI_WORKER,
                                      REPO, json.dumps(argv)],
                    PYTHONPATH=REPO)


def _rows(text: str) -> list:
    return [ln.split(",") for ln in text.splitlines()
            if ln.split(",")[0].isdigit()]


@pytest.mark.parametrize("algorithm", [[], ["--overlap", "True",
                                            "--staleness", "2"]])
def test_cli_groups_csv_and_dcp_resume(tmp_path, capsys, algorithm):
    argv = ARGV + algorithm
    straight, split = tmp_path / "straight", tmp_path / "split"
    root = f"lm_dcp_global_n{WORLD}"
    runs = [_cli(argv + ["--num_steps", "3", "--checkpoint_dir",
                         str(straight)])]
    # the straight run's step-2 save, alone, is the resume's start
    shutil.copytree(straight, split)
    shutil.rmtree(split / root / "3")
    runs.append(_cli(argv + ["--num_steps", "3", "--resume", "True",
                             "--checkpoint_dir", str(split)]))
    assert "resumed from step 2" in runs[1][0]
    assert ("--pp 2 under torchrun: checkpoints through --ckpt_backend "
            "orbax") in runs[0][0]
    assert "world 4 = dp 2 x pp 2 (process 0: replica 0, stage 0)" in (
        runs[0][0])
    a, b = _dcp(straight / root / "3"), _dcp(split / root / "3")
    assert set(a) == set(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a stage leaf is written as its logical [dp, L, ...] rows, a
    # replicated leaf once
    assert tuple(a["state.params.stack.attn.q.weight"].shape) == (
        DP, 4, 32, 32)
    assert tuple(a["state.params.embed.weight"].shape) == (DP, 64, 32)
    # every process's CSV holds the stacked run's rows to their printed
    # digits (tokens/s left out)
    gossip_lm.main(argv + ["--num_steps", "3", "--world_size", str(WORLD),
                           "--checkpoint_dir", str(tmp_path / "stacked")])
    stacked = [r[:4] + r[5:] for r in _rows(capsys.readouterr().out)]
    for p in range(WORLD):
        csv = (straight / f"lm_out_p{p}_n{WORLD}.csv").read_text()
        got = [r[:4] + r[5:] for r in _rows(csv)]
        assert got == stacked, p
    layout = make_dp_sp_layout(WORLD, 1, 1, 1, PP)
    for p in range(WORLD):
        replica, s = divmod(p, PP)
        pipe = layout.pp_members(replica)
        dp = layout.dp_members(0, 0, 0, s)
        # sum_stages: the gradients' and the loss's sum over the stages,
        # and the grad norm's mean
        group = {"_exchange": pipe, "sum_stages": pipe, "mean": dp, "pre_step": dp, "post_step": dp,
                 "any_process": list(range(WORLD)),
                 "consensus_resume_point": list(range(WORLD))}
        want = {"_exchange", "sum_stages", "mean", "any_process", "consensus_resume_point",
                "pre_step" if algorithm else "post_step"}
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert want <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group:
                assert got == group[who], (p, op, who, got)
