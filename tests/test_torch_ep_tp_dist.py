"""The expert meshes across processes: one ``(e, shard, t)`` shard a gloo
process (``parallel/ep.py::DistEp`` beside ``DistSeq`` and ``DistTp``,
each on its own group), held against the stacked lane (``StackedEp``,
``StackedSeq``, ``StackedTp``: a replica's shards in one process) on the
same numpy data, at ``tests/test_torch_ep_tp.py``'s sizes (d32, L2, h4,
F64, V64, 4 experts on block 1, T32, B2).

* Process ``p`` is ``(replica, e, shard, t)`` of the reference's
  ``make_dp_ep_sp_tp_mesh`` order (``DpSpLayout.grid``); its dp
  transport, DistEp, DistSeq and DistTp sit on the groups of that cell,
  and it holds its expert slice ``[1, 1, E/ep, ...]`` of every stack.
* Two steps and the eval step at 8 processes of dp 2 x ep 2 x tp 2 (SGP,
  OSGP at staleness 2), 8 of dp 1 x ep 2 x sp 2 x tp 2 and 4 of dp 1 x
  ep 2 x sp 2 (SGP, ring attention), and MoE at ep 1 in 4 of dp 2 x tp 2
  (SGP): losses, ``ppl``, grad norms,
  params, momentum, the push-sum weight and the eval loss against the
  stacked replica's slice.  They are not bit-equal: the stack takes one
  gradient of the mean over a replica's ep (and sequence) shards, a
  process its own shard's gradient, meaned over the sp group and summed
  over the ep group (``parallel/ep.py``; the tp sums alone are the same
  folds on both lanes, ``test_torch_tp_dist.py``, so MoE at dp 2 x tp 2
  is held bit-equal).  So losses and ``ppl``
  1e-5 relative, grad norms 1e-4 relative, params and momentum atol
  2e-6 (``test_torch_ep_dist.py``'s tolerances), the dropped fraction
  and the push-sum weight exactly.  Every process of a replica holds the
  replicated leaves bit-equal; each exchanges its slots four times a MoE
  block a step (dispatch and combine, forward and backward).
* The command line at dp 1 x ep 2 x sp 2 x tp 2 under a torchrun
  environment: every collective recorded by its class and caller (the
  exchange, the ep gradient sum and mean on the ``(replica, shard, t)``
  ep group, the tp sums on the ``(replica, e, shard)`` tp group, ring
  shifts and the sequence mean on the ``(replica, e, t)`` sp group, the
  metric means on the ``(e, shard, t)`` dp group, agreement on the
  world); checkpoints through the DCP backend (forced, logged), expert
  stacks written as their logical rows; a resume from the step-2 save
  to step 3 leaves the same checkpoint, bit for bit, as the run that
  went on; each process's CSV carries ``moe_dropped`` and the rows are
  the stacked run's to their printed digits.

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
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import StackedTp, split_dim
from stochastic_gradient_push_torch.run import gossip_lm
import torch_ep_drive as drive
from test_torch_tp_dist import _dcp
from torch_launch import spawn, torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
E, FF = 4, 64
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
# (dp, ep, sp, tp) -> the algorithms each runs
LAYOUTS = {(2, 2, 1, 2): ("sgp", "osgp"), (1, 2, 2, 2): ("sgp",),
           (1, 2, 2, 1): ("sgp",), (2, 1, 1, 2): ("sgp",)}

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
from stochastic_gradient_push_torch.parallel.seq import DistSeq
from stochastic_gradient_push_torch.parallel.tp import DistTp
import torch_ep_drive as drive

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
out = {}
for (dp, ep, sp, tp), names in job["layouts"]:
    key = f"{dp}{ep}{sp}{tp}"
    layout = make_dp_sp_layout(world, sp, tp, ep)
    groups = join_groups(layout, rank)
    transport = DistTransport(group=groups.dp,
                              siblings=layout.all_dp_members())
    for name in names:
        ax = {"ep": DistEp(DistTransport(group=groups.ep)) if ep > 1
              else None,
              "seq": DistSeq(DistTransport(group=groups.sp)) if sp > 1
              else None,
              "tp": DistTp(DistTransport(group=groups.tp)) if tp > 1
              else None}
        got = drive.run(name, dp, transport, ax["ep"],
                        drive.batches(dp, ep, sp, job["seed"]), sp=sp,
                        seq=ax["seq"], impl="ring" if sp > 1 else "full",
                        tp=ax["tp"], experts=job["experts"], ff=job["ff"])
        out.update({f"{key}/{name}/{k}": v for k, v in got.items()})
    shards = [a.shards[0] if a is not None else 0
              for a in (ax["ep"], ax["seq"], ax["tp"])]
    out[f"{key}/place"] = np.array([*layout.grid(rank), transport.rank,
                                    *shards])
    # each axis's group (every one is of 2 here), -1s where it is 1
    out[f"{key}/groups"] = np.array([
        dist.get_process_group_ranks(g) if n > 1 else [-1] * 2
        for g, n in ((groups.ep, ep), (groups.sp, sp), (groups.tp, tp))])
np.savez(job["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(world: int, layouts: list, tmp) -> list[dict]:
    job = {"layouts": layouts, "seed": 5, "experts": E, "ff": FF,
           "out": str(tmp / "rank%d.npz")}
    spawn(world, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, TESTS, str(r), str(world),
        str(port), json.dumps(job)], PYTHONPATH=REPO)
    return [dict(np.load(job["out"] % r)) for r in range(world)]


def _stacked(dp, ep, sp, tp, name) -> dict:
    return drive.run(name, dp, StackedTransport(dp),
                     StackedEp(ep) if ep > 1 else None,
                     drive.batches(dp, ep, sp, 5), sp=sp,
                     seq=StackedSeq(sp) if sp > 1 else None,
                     impl="ring" if sp > 1 else "full",
                     tp=StackedTp(tp) if tp > 1 else None, experts=E, ff=FF)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    torch.set_num_threads(1)
    rows = {}
    for world in (8, 4):
        mine = [(list(k), list(v)) for k, v in LAYOUTS.items()
                if k[1] * k[2] * k[3] * k[0] == world]
        got = _spawn(world, mine, tmp_path_factory.mktemp(f"eptp{world}"))
        for k, _ in mine:
            rows[tuple(k)] = got
    want = {(k, name): _stacked(*k, name)
            for k, names in LAYOUTS.items() for name in names}
    return rows, want


def _key(dims) -> str:
    return "".join(map(str, dims))


@pytest.mark.parametrize("dims", list(LAYOUTS))
def test_processes_sit_on_the_reference_grid(lanes, dims):
    rows, _ = lanes
    dp, ep, sp, tp = dims
    layout = make_dp_sp_layout(dp * ep * sp * tp, sp, tp, ep)
    for p, row in enumerate(rows[dims]):
        replica, e, shard, t = layout.grid(p)
        assert p == ((replica * ep + e) * sp + shard) * tp + t
        # the dp transport's rank is the replica; each axis's shard is
        # the process's index on it
        assert list(row[f"{_key(dims)}/place"]) == [
            replica, e, shard, t, replica, e if ep > 1 else 0,
            shard if sp > 1 else 0, t if tp > 1 else 0]
        groups = row[f"{_key(dims)}/groups"]
        for got, size, members in (
                (groups[0], ep, layout.ep_members(replica, shard, t)),
                (groups[1], sp, layout.sp_members(replica, t, e)),
                (groups[2], tp, layout.tp_members(replica, shard, e))):
            if size > 1:
                assert list(got) == members


def _mine(p, dims, key, stacked):
    """The stacked run's slice process ``p`` holds: its replica's rows,
    of a tp-split leaf its shard, of an expert stack its experts."""
    dp, ep, sp, tp = dims
    replica, e, _, t = make_dp_sp_layout(dp * ep * sp * tp, sp, tp,
                                         ep).grid(p)
    w = stacked[replica:replica + 1]
    part, name = key.split("/", 1)[0], key.split("/", 1)[-1]
    if part in ("params", "momentum"):
        split = tp > 1 and split_dim(name) is not None
        if split:
            w = w[:, t:t + 1]
        if ep > 1 and is_expert(name):
            w = np.split(w, ep, axis=2 if split else 1)[e]
    return w


@pytest.mark.parametrize("dims,name", [(k, n) for k, names in
                                       LAYOUTS.items() for n in names])
def test_lm_step_against_the_stack(lanes, dims, name):
    rows, want = lanes
    stacked = want[dims, name]
    prefix = f"{_key(dims)}/{name}/"
    dp, ep, sp, tp = dims
    layout = make_dp_sp_layout(dp * ep * sp * tp, sp, tp, ep)
    for p, row in enumerate(rows[dims]):
        replica = layout.grid(p)[0]
        first = layout.proc(replica, 0, 0, 0)
        for k, w in stacked.items():
            part = k.split("/", 1)[0]
            if part in ("exchanges", "reductions", "shifts"):
                continue
            g = row[prefix + k]
            if part in ("params", "momentum") and not is_expert(k) and (
                    tp == 1 or split_dim(k.split("/", 1)[1]) is None):
                # the replicated state is the same in all of a replica's
                # processes
                np.testing.assert_array_equal(
                    g, rows[dims][first][prefix + k], err_msg=k)
            w = _mine(p, dims, k, w)
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if part in ("ps_weight", "moe_dropped") or ep == sp == 1:
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
        # dispatch and combine, forward and backward, for the MoE block a
        # step, and the eval step's two
        assert int(row[prefix + "exchanges"]) == (
            4 * drive.STEPS + 2 if ep > 1 else 0)
        assert int(row.get(prefix + "reductions", 0)) > 0 or tp == 1
        assert int(row.get(prefix + "shifts", 0)) > 0 or sp == 1


# -- the command line: groups, the CSV and the DCP backend ---------------

_CLI_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = {("DistEp", "_all_to_all"), ("DistEp", "reduce_grads"),
       ("DistEp", "pmean"), ("DistTp", "_all"), ("DistSeq", "_hop"),
       ("DistSeq", "pmean"), (None, "mean"), (None, "any_process"),
       (None, "consensus_resume_point")}
calls = []

def members(group):
    return dist.get_process_group_ranks(group or dist.group.WORLD)

def who():
    f = sys._getframe(2)
    while f is not None:
        owner = type(f.f_locals.get("self")).__name__ if (
            "self" in f.f_locals) else None
        if (owner, f.f_code.co_name) in WHO:
            return f"{owner}.{f.f_code.co_name}" if owner else (
                f.f_code.co_name)
        f = f.f_back
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

DP, EP, SP, TP = 1, 2, 2, 2
WORLD = DP * EP * SP * TP
ARGV = ["--device", "cpu", "--moe_experts", str(E), "--ep", str(EP),
        "--sp", str(SP), "--tp", str(TP), "--attn", "ring_flash",
        "--remat", "True", "--vocab_size", "64", "--d_model", "16",
        "--n_layers", "2", "--n_heads", "4", "--d_ff", "32", "--seq_len",
        "16", "--batch_size", "2", "--print_freq", "1", "--corpus_tokens",
        "2000", "--ckpt_every", "2"]


def _cli(argv: list) -> list[str]:
    return torchrun(WORLD, lambda r: [sys.executable, "-c", _CLI_WORKER,
                                      REPO, json.dumps(argv)],
                    PYTHONPATH=REPO)


def _rows(text: str) -> list:
    return [ln.split(",") for ln in text.splitlines()
            if ln.split(",")[0].isdigit()]


def test_cli_groups_csv_and_dcp_resume(tmp_path, capsys):
    straight, split = tmp_path / "straight", tmp_path / "split"
    root = f"lm_dcp_global_n{WORLD}"
    runs = [_cli(ARGV + ["--num_steps", "3", "--checkpoint_dir",
                         str(straight)])]
    # the straight run's step-2 save, alone, is the resume's start
    shutil.copytree(straight, split)
    shutil.rmtree(split / root / "3")
    runs.append(_cli(ARGV + ["--num_steps", "3", "--resume", "True",
                             "--checkpoint_dir", str(split)]))
    assert "resumed from step 2" in runs[1][0]
    assert ("--tp 2 under torchrun: checkpoints through --ckpt_backend "
            "orbax") in runs[0][0]
    assert (f"world {WORLD} = dp {DP} x ep {EP} x sp {SP} x tp {TP} "
            f"(process 0: replica 0, ep shard 0, shard 0, tp shard 0)") in (
        runs[0][0])
    a, b = _dcp(straight / root / "3"), _dcp(split / root / "3")
    assert set(a) == set(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # an expert stack is written as its logical rows, one a replica
    assert tuple(a["state.params.block_1.moe.experts_up"].shape) == (
        DP, E, 16, 32)
    assert tuple(a["state.params.block_1.moe.experts_down"].shape) == (
        DP, E, 32, 16)
    assert tuple(a["state.params.block_1.moe.router"].shape) == (DP, 16, E)
    # every process's CSV carries moe_dropped; the rows are the stacked
    # run's to their printed digits, one unit of the last apart at most
    # (step, loss, ppl, lr, grad_norm, moe_dropped; tokens/s left out)
    unit = np.array([0, 1e-4, 1e-2, 1e-5, 1e-4, 1e-4]) * (1 + 1e-6)
    gossip_lm.main(ARGV + ["--num_steps", "3", "--world_size", str(WORLD),
                           "--checkpoint_dir", str(tmp_path / "stacked")])
    stacked = [r[:4] + r[5:] for r in _rows(capsys.readouterr().out)]
    for p in range(WORLD):
        csv = (straight / f"lm_out_p{p}_n{WORLD}.csv").read_text()
        assert csv.splitlines()[0].endswith(",grad_norm,moe_dropped")
        got = [r[:4] + r[5:] for r in _rows(csv)]
        assert len(got) == 3
        for g, w in zip(got, stacked):
            assert np.all(np.abs(np.float64(g) - np.float64(w)) <= unit), (
                g, w)
    layout = make_dp_sp_layout(WORLD, SP, TP, EP)
    for p in range(WORLD):
        replica, e, shard, t = layout.grid(p)
        ep_group = layout.ep_members(replica, shard, t)
        sp_group = layout.sp_members(replica, t, e)
        group = {"DistEp._all_to_all": ep_group,
                 "DistEp.reduce_grads": ep_group, "DistEp.pmean": ep_group,
                 "DistTp._all": layout.tp_members(replica, shard, e),
                 "DistSeq._hop": sp_group, "DistSeq.pmean": sp_group,
                 "mean": layout.dp_members(shard, t, e),
                 "any_process": list(range(WORLD)),
                 "consensus_resume_point": list(range(WORLD))}
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert set(group) <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group:
                assert got == group[who], (p, op, who, got)
