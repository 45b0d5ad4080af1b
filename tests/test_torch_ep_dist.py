"""The expert axis across processes (``parallel/ep.py::DistEp``): one ep
shard a gloo process, held against the stacked lane (``StackedEp``, all
shards in one process) on the same numpy data, at world 4 = dp 2 x ep 2.

* Process ``p`` is ``(replica, e) = (p // ep, p % ep)``, the reference's
  ``make_dp_ep_mesh`` order; its DistEp and dp transport say so, and it
  holds ``1/ep`` of every expert stack (its experts' slice) and the
  replicated leaves whole.
* The LM step (SGP, SGP on the int8 wire, SGP on the gossip kernel
  lane's twin, OSGP at staleness 2, AllReduce), two steps and the eval
  step: losses, ``ppl``, ``moe_dropped``, grad norms, params, momentum,
  the push-sum weight and the eval loss against the stacked replica's
  (its rows, and of an expert stack its shard's slice).  They are not
  bit-equal: the stack takes one gradient of the mean over both shards'
  tokens, each process the gradient of its own shard's mean, summed over
  the ep group and halved.  So losses and ``ppl`` 1e-5 relative, grad
  norms 1e-4 relative, params and momentum atol 2e-6 (the port's other
  process-lane tolerances, ``test_torch_seq_dist.py``), the dropped
  fraction and the push-sum weight exactly.  A replica's ep processes
  hold bit-equal replicated leaves, and each exchanges its slots four
  times a MoE block a step (dispatch and combine, forward and backward).
* The command line under a torchrun environment: every collective
  recorded by its caller (the exchange, the ep gradient sum and the ep
  means on the ``(replica)`` ep group, the gossip round and the metric
  means on the ``e`` dp group, agreement on the world); checkpoints
  through the DCP backend (forced at ``--ep`` > 1, logged), an expert
  stack written as its logical rows; a resume from the step-2 save to
  step 3 leaves the same checkpoint, bit for bit, as the run that went
  on; each process's CSV carries ``moe_dropped``, and the rows are the
  stacked ``--world_size 4 --ep 2`` run's to their printed digits.

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
from stochastic_gradient_push_torch.parallel.ep import StackedEp, is_expert
from stochastic_gradient_push_torch.parallel.mesh import make_dp_sp_layout
from stochastic_gradient_push_torch.run import gossip_lm
import torch_ep_drive as drive
from test_torch_tp_dist import _dcp
from torch_launch import spawn, torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DP, EP = 2, 2
WORLD = DP * EP
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6

_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.parallel.collectives import (
    DistTransport)
from stochastic_gradient_push_torch.parallel.ep import DistEp
from stochastic_gradient_push_torch.parallel.mesh import (
    join_groups, make_dp_sp_layout)
import torch_ep_drive as drive

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
layout = make_dp_sp_layout(world, 1, 1, job["ep"])
groups = join_groups(layout, rank)
transport = DistTransport(group=groups.dp, siblings=layout.all_dp_members())
out = {}
for name in job["algorithms"]:
    ep = DistEp(DistTransport(group=groups.ep))
    got = drive.run(name, layout.dp, transport, ep,
                    drive.batches(layout.dp, job["ep"], 1, job["seed"]))
    out.update({f"{name}/{k}": v for k, v in got.items()})
out["place"] = np.array([*layout.grid(rank), transport.rank, ep.shards[0]])
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
    rows = _spawn({"ep": EP, "seed": 5, "algorithms": list(
        drive.ALGORITHMS)}, tmp_path_factory.mktemp("ep22"))
    want = {}
    for name in drive.ALGORITHMS:
        got = drive.run(name, DP, StackedTransport(DP), StackedEp(EP),
                        drive.batches(DP, EP, 1, 5))
        want.update({f"{name}/{k}": v for k, v in got.items()})
    return rows, want


def test_processes_sit_on_the_reference_grid(lanes):
    rows, _ = lanes
    layout = make_dp_sp_layout(WORLD, 1, 1, EP)
    for p, row in enumerate(rows):
        replica, e, shard, t = layout.grid(p)
        assert (replica, e, shard, t) == (p // EP, p % EP, 0, 0)
        # the dp transport's rank is the replica, the DistEp's shard is e
        assert list(row["place"]) == [replica, e, 0, 0, replica, e]
    assert layout.ep_members(1) == [2, 3]
    assert layout.all_dp_members() == [[0, 2], [1, 3]]


def _mine(p, key, stacked):
    """The stacked run's rows of process ``p``: its replica's, and of an
    expert stack its shard's slice."""
    replica, e = divmod(p, EP)
    w = stacked[replica:replica + 1]
    name = key.split("/", 2)[-1]
    if key.split("/")[1] in ("params", "momentum") and is_expert(name):
        w = np.split(w, EP, axis=1)[e]
    return w


@pytest.mark.parametrize("name", drive.ALGORITHMS)
def test_lm_step_against_the_stack(lanes, name):
    rows, want = lanes
    keys = [k for k in want if k.startswith(name + "/") and
            k != f"{name}/exchanges"]
    for p, row in enumerate(rows):
        replica, e = divmod(p, EP)
        if e:
            # the replicated state is the same in a replica's ep processes
            for k in keys:
                part, leaf = k.split("/")[1], k.split("/")[-1]
                if part in ("params", "momentum") and not is_expert(leaf):
                    np.testing.assert_array_equal(row[k], rows[p - e][k],
                                                  err_msg=k)
        # dispatch and combine, forward and backward, for the one MoE
        # block a step, and the eval step's two
        assert int(row[f"{name}/exchanges"]) == 4 * drive.STEPS + 2
        for k in keys:
            w, g = _mine(p, k, want[k]), row[k]
            part = k.split("/")[1]
            assert g.shape == w.shape, k
            if part in ("ps_weight", "moe_dropped"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif part in ("loss", "ppl", "eval_loss"):
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif part == "grad_norm":
                np.testing.assert_allclose(g, w, rtol=GN_RTOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                           err_msg=k)


# -- the command line: groups, the CSV and the DCP backend ---------------

_CLI_WORKER = r"""
import json, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = ("_all_to_all", "reduce_grads", "pmean", "mean", "any_process",
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
dist.all_to_all_single = spy("all_to_all_single", dist.all_to_all_single,
                             lambda a, k: k.get("group"))
dist.batch_isend_irecv = spy("batch_isend_irecv", dist.batch_isend_irecv,
                             lambda a, k: a[0][0].group)
from stochastic_gradient_push_torch.run import gossip_lm
try:
    gossip_lm.main(json.loads(sys.argv[2]))
finally:
    print("CALLS " + json.dumps(calls), flush=True)
"""

ARGV = ["--device", "cpu", "--moe_experts", "4", "--ep", str(EP),
        "--vocab_size", "64", "--d_model", "16", "--n_layers", "2",
        "--n_heads", "4", "--d_ff", "32", "--seq_len", "16",
        "--batch_size", "2", "--print_freq", "1", "--corpus_tokens", "2000",
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
    assert ("--ep 2 under torchrun: checkpoints through --ckpt_backend "
            "orbax") in runs[0][0]
    assert f"world 4 = dp 2 x ep 2 (process 0: replica 0, ep shard 0)" in (
        runs[0][0])
    a, b = _dcp(straight / root / "3"), _dcp(split / root / "3")
    assert set(a) == set(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # an expert stack is written as its logical rows, one a replica
    assert tuple(a["state.params.block_1.moe.experts_up"].shape) == (
        DP, 4, 16, 32)
    assert tuple(a["state.params.block_1.moe.router"].shape) == (DP, 16, 4)
    # every process's CSV carries moe_dropped; the rows are the stacked
    # run's to their printed digits (tokens/s left out)
    gossip_lm.main(argv + ["--num_steps", "3", "--world_size", str(WORLD),
                           "--checkpoint_dir", str(tmp_path / "stacked")])
    stacked = [r[:4] + r[5:] for r in _rows(capsys.readouterr().out)]
    for p in range(WORLD):
        csv = (straight / f"lm_out_p{p}_n{WORLD}.csv").read_text()
        assert csv.splitlines()[0].endswith(",grad_norm,moe_dropped")
        got = [r[:4] + r[5:] for r in _rows(csv)]
        assert len(got) == 3
        for g, w in zip(got, stacked):
            np.testing.assert_allclose(np.float64(g), np.float64(w),
                                       rtol=0, atol=2e-4)
    layout = make_dp_sp_layout(WORLD, 1, 1, EP)
    for p in range(WORLD):
        replica, e, _, _ = layout.grid(p)
        group = {"_all_to_all": layout.ep_members(replica),
                 "reduce_grads": layout.ep_members(replica),
                 "pmean": layout.ep_members(replica),
                 "mean": layout.dp_members(0, 0, e),
                 "pre_step": layout.dp_members(0, 0, e),
                 "post_step": layout.dp_members(0, 0, e),
                 "any_process": list(range(WORLD)),
                 "consensus_resume_point": list(range(WORLD))}
        want = {"_all_to_all", "reduce_grads", "pmean", "mean",
                "any_process", "consensus_resume_point",
                "pre_step" if algorithm else "post_step"}
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert want <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group:
                assert got == group[who], (p, op, who, got)
