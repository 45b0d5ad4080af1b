"""The tensor axis across processes (``parallel/tp.py::DistTp``): one tp
shard a gloo process, held against the stacked lane (``StackedTp``, all
shards in one process) on the same numpy data.

* Process ``p`` is ``(replica, shard, t) = (p // (sp·tp), (p // tp) %
  sp, p % tp)``, the reference's ``make_dp_sp_tp_mesh`` order; its
  DistTp, DistSeq and dp transport say so.
* The LM step at dp 2 x tp 2 (4 processes; SGP, SGP on the gossip kernel
  lane's twin, SGP on the int8 wire, SGP at bf16, OSGP at staleness 2,
  AllReduce, D-PSGD, AD-PSGD), three steps and the eval step: losses, grad norms,
  params, momentum, push-sum and FIFO weights and the eval loss **bit-
  equal** to the stacked replica's (every sum over the shards is the
  same fold in shard order on both lanes).  Every split leaf is held as
  ``1/tp`` of its logical leaf; the replicated leaves are bit-equal
  across a replica's tp processes.  Each process reduces over its tp
  group as often as the stack does for one replica.
* At dp 1 x sp 2 x tp 2 (``ring_flash``, remat): the tp shards of every
  ``(replica, shard)`` and the sequence shards of every ``(replica, t)``
  hold the same replicated state, bit for bit; against the stack the
  sequence axis keeps its own tolerances (``test_torch_seq_dist.py``:
  the stack sums a weight's gradient over its shards' rows in one
  product, the processes mean the shards' products, so losses 1e-5
  relative, grad norms 1e-4 relative, params and momentum atol 2e-6, the
  push-sum weight exact).
* The command line at dp 2 x tp 2, at dp 1 x sp 2 x tp 2 and at dp 1 x
  tp 4 (bf16), with every
  collective recorded by its caller: the tp sums on the ``(replica,
  shard)`` tp group, ring shifts and the loss/gradient mean on the
  ``(replica, t)`` sp group, the gossip round and the metric means on
  the ``(shard, t)`` dp group, signal and resume agreement on the world.
  Each run checkpoints through the DCP backend (forced at ``--tp`` > 1,
  logged), and a resume from its step-2 save to step 3 leaves the same
  checkpoint, bit for bit, as the run that went on (OSGP, saving every 2
  steps, the FIFO drained at each save); so does ``--sp 2`` at ``--tp 1``
  (dp 2 x sp 2), which the DCP backend refused before.

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
from stochastic_gradient_push_torch.parallel.mesh import (
    make_dp_sp_layout)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import StackedTp, split_dim
from stochastic_gradient_push_torch.train import lm as tlm
import torch_tp_drive as drive
from torch_launch import spawn, torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6

_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.parallel.collectives import (
    DistTransport)
from stochastic_gradient_push_torch.parallel.mesh import (
    join_dp_sp_tp_groups, make_dp_sp_layout)
from stochastic_gradient_push_torch.parallel.seq import DistSeq
from stochastic_gradient_push_torch.parallel.tp import DistTp
import torch_tp_drive as drive
from torch_launch import spawn, torchrun

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
layout = make_dp_sp_layout(world, job["sp"], job["tp"])
tp_group, sp_group, dp_group = join_dp_sp_tp_groups(layout, rank)
seq = DistSeq(DistTransport(group=sp_group)) if job["sp"] > 1 else None
transport = DistTransport(group=dp_group, siblings=[
    layout.dp_members(i, t) for i in range(layout.sp)
    for t in range(layout.tp)])
out = {}
for name in job["algorithms"]:
    tp = DistTp(DistTransport(group=tp_group))
    got = drive.run(name, layout.dp, transport, seq, tp,
                    drive.batches(layout.dp, job["sp"], job["seed"]),
                    impl=job["impl"], remat=job["remat"])
    out.update({f"{name}/{k}": v for k, v in got.items()})
out["place"] = np.array([*layout.index(rank), transport.rank,
                         tp.shards[0], -1 if seq is None else seq.shards[0]])
np.savez(job["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(world: int, job: dict, tmp) -> list[dict]:
    """Run the worker in ``world`` gloo processes; each one's results."""
    job = dict(job, out=str(tmp / "rank%d.npz"))
    spawn(world, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, TESTS, str(r), str(world),
        str(port), json.dumps(job)], PYTHONPATH=REPO)
    return [dict(np.load(job["out"] % r)) for r in range(world)]


def _lm(dp, sp, tp, impl, remat, algorithms, seed, tmp):
    rows = _spawn(dp * sp * tp, {"sp": sp, "tp": tp, "seed": seed,
                                 "impl": impl, "remat": remat,
                                 "algorithms": list(algorithms)}, tmp)
    want = {}
    for name in algorithms:
        got = drive.run(name, dp, StackedTransport(dp),
                        StackedSeq(sp) if sp > 1 else None, StackedTp(tp),
                        drive.batches(dp, sp, seed), impl=impl, remat=remat)
        want.update({f"{name}/{k}": v for k, v in got.items()})
    return make_dp_sp_layout(dp * sp * tp, sp, tp), rows, want


@pytest.fixture(scope="module")
def lm_dp2_tp2(tmp_path_factory):
    return _lm(2, 1, 2, "full", False, drive.ALGORITHMS, 5,
               tmp_path_factory.mktemp("tp22"))


@pytest.fixture(scope="module")
def lm_dp1_sp2_tp2(tmp_path_factory):
    return _lm(1, 2, 2, "ring_flash", True, ("sgp",), 9,
               tmp_path_factory.mktemp("tp122"))


def _mine(layout, p, key, stacked):
    """The stacked run's rows of process ``p``: its replica's, and of a
    split leaf its tp shard's."""
    replica, _, t = layout.index(p)
    w = stacked[replica:replica + 1]
    name = key.split("/", 2)[-1]
    if key.split("/")[1] in ("params", "momentum") and (
            split_dim(name) is not None):
        w = w[:, t:t + 1]
    return w


def test_processes_take_the_reference_device_order(lm_dp2_tp2,
                                                   lm_dp1_sp2_tp2):
    for layout, rows, _ in (lm_dp2_tp2, lm_dp1_sp2_tp2):
        for p, row in enumerate(rows):
            tp, sp = layout.tp, layout.sp
            replica, shard, t = p // (sp * tp), (p // tp) % sp, p % tp
            assert row["place"].tolist() == [
                replica, shard, t, replica, t, shard if sp > 1 else -1]


@pytest.mark.parametrize("name", drive.ALGORITHMS)
def test_lm_step_dp2_tp2_across_processes_equals_the_stack(lm_dp2_tp2,
                                                           name):
    layout, rows, want = lm_dp2_tp2
    keys = [k for k in want if k.startswith(name + "/")
            and not k.endswith("/reductions")]
    shapes = tlm.logical_shapes(drive.config(1))
    for p, row in enumerate(rows):
        for k in keys:
            np.testing.assert_array_equal(
                row[k], _mine(layout, p, k, want[k]), err_msg=k)
        # a split leaf holds 1/tp of its logical leaf, a replicated one
        # all of it and the same bits as its tp sibling's
        sibling = rows[p ^ 1]
        for n, shape in shapes.items():
            got = row[f"{name}/params/{n}"]
            if split_dim(n) is not None:
                assert got.shape[:2] == (1, 1)
                assert got.size * layout.tp == int(np.prod(shape)), n
            else:
                assert got.shape == (1, *shape), n
                np.testing.assert_array_equal(
                    got, sibling[f"{name}/params/{n}"], err_msg=n)
        # one replica's sums over the shards, in each of its processes
        assert int(row[f"{name}/reductions"]) * layout.dp == int(
            want[f"{name}/reductions"])


def test_lm_step_dp1_sp2_tp2_across_processes(lm_dp1_sp2_tp2):
    layout, rows, want = lm_dp1_sp2_tp2
    keys = [k for k in want if not k.endswith("/reductions")]
    for p, row in enumerate(rows):
        replica, shard, t = layout.index(p)
        # the same state in every sequence shard of (replica, t), and the
        # replicated leaves in every tp shard of (replica, shard)
        for q in layout.sp_members(replica, t):
            for k in keys:
                np.testing.assert_array_equal(row[k], rows[q][k], err_msg=k)
        for q in layout.tp_members(replica, shard):
            for k in keys:
                name = k.split("/", 2)[-1]
                if k.split("/")[1] not in ("params", "momentum") or (
                        split_dim(name) is None):
                    np.testing.assert_array_equal(row[k], rows[q][k],
                                                  err_msg=k)
        for k in keys:
            w, g = _mine(layout, p, k, want[k]), row[k]
            part = k.split("/")[1]
            if part in ("ps_weight", "in_flight"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif part in ("loss", "eval_loss"):
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif part == "grad_norm":
                np.testing.assert_allclose(g, w, rtol=GN_RTOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                           err_msg=k)


# -- the command line: groups and the DCP backend --------------------------

_CLI_WORKER = r"""
import json, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = ("_all", "_hop", "pmean", "mean", "any_process",
       "consensus_resume_point", "pre_step", "post_step", "reduce_grads")
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


def _cli(world: int, argv: list) -> list[str]:
    return torchrun(world, lambda r: [sys.executable, "-c", _CLI_WORKER,
                                      REPO, json.dumps(argv)],
                    PYTHONPATH=REPO)


def _dcp(path) -> dict:
    """Every tensor of a DCP checkpoint directory, on the host."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata()
    out = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
           for k, m in meta.state_dict_metadata.items()
           if hasattr(m, "size")}
    dcp.load(out, checkpoint_id=str(path), no_dist=True)
    return out


@pytest.mark.parametrize("sp,tp,precision", [(1, 2, "fp32"), (2, 2, "fp32"),
                                            (2, 1, "fp32"), (1, 4, "bf16")])
def test_cli_groups_and_dcp_resume(tmp_path, sp, tp, precision):
    world = 4
    dp = world // (sp * tp)
    argv = ["--device", "cpu", "--sp", str(sp), "--tp", str(tp),
            "--precision", precision,
            "--vocab_size", "64", "--d_model", "16", "--n_layers", "1",
            "--n_heads", "4", "--d_ff", "32", "--seq_len", "16",
            "--batch_size", "2", "--print_freq", "1",
            "--corpus_tokens", "2000", "--overlap", "True",
            "--staleness", "2", "--ckpt_every", "2"] + (
                ["--attn", "ring"] if sp > 1 else [])
    if tp == 1:
        argv += ["--ckpt_backend", "orbax"]
    straight, split = tmp_path / "straight", tmp_path / "split"
    root = f"lm_dcp_global_n{world}"
    runs = [_cli(world, argv + ["--num_steps", "3", "--checkpoint_dir",
                                str(straight)])]
    # the straight run's step-2 save, alone, is the resume's start
    shutil.copytree(straight, split)
    shutil.rmtree(split / root / "3")
    runs.append(_cli(world, argv + ["--num_steps", "3", "--resume", "True",
                                    "--checkpoint_dir", str(split)]))
    assert "resumed from step 2" in runs[1][0]
    assert ("checkpoints through --ckpt_backend orbax" in runs[0][0]) == (
        tp > 1)
    a, b = _dcp(straight / root / "3"), _dcp(split / root / "3")
    assert set(a) == set(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a split leaf is written as its logical rows, one a replica
    assert tuple(a["state.params.block_0.attn.q.weight"].shape) == (
        dp, 16, 16)
    assert tuple(a["state.ps_weight"].shape) == (dp,)
    layout = make_dp_sp_layout(world, sp, tp)
    group = {}
    for p in range(world):
        replica, shard, t = layout.index(p)
        group[p] = {"_all": layout.tp_members(replica, shard),
                    "_hop": layout.sp_members(replica, t),
                    "pmean": layout.sp_members(replica, t),
                    "mean": layout.dp_members(shard, t),
                    "pre_step": layout.dp_members(shard, t),
                    "post_step": layout.dp_members(shard, t),
                    "any_process": list(range(world)),
                    "consensus_resume_point": list(range(world))}
    want = {"mean", "any_process", "consensus_resume_point"}
    # OSGP launches its round at the top of the step
    want |= {"pre_step"} if dp > 1 else set()
    want |= {"_all"} if tp > 1 else set()
    want |= {"_hop", "pmean"} if sp > 1 else set()
    for p in range(world):
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert want <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group[p]:
                assert got == group[p][who], (p, op, who, got)


def test_peer_links_stay_apart_over_every_dp_group():
    """With sp·tp dp groups mapping their landing blocks at once, each
    gossip rank's handle sits under the global rank of the process that
    holds it: no two groups share a key."""
    from stochastic_gradient_push_torch.ops.gossip_kernel import PeerLinks

    layout = make_dp_sp_layout(16, 2, 2)
    keys = []
    for shard in range(2):
        for t in range(2):
            members = layout.dp_members(shard, t)
            links = PeerLinks(0, layout.dp, members=members)
            keys += [links.handle_key("link", r) for r in range(layout.dp)]
            assert members == [(r * 2 + shard) * 2 + t
                               for r in range(layout.dp)]
    assert len(keys) == len(set(keys)) == 16
