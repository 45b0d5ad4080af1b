"""The pipeline meshes across processes: ``--pp`` beside ``--sp``,
``--ep`` or both, one ``(replica, stage, ep shard, sequence shard)`` a
gloo process (``parallel/pipeline.py::DistPipe`` with ``parallel/seq.py::
DistSeq`` and ``parallel/ep.py::DistEp``), held against the stacked lane
(``StackedPipe``, ``StackedSeq``, ``StackedEp``: a replica in one
process) on the same numpy data.

* The meshes: ``(gossip, pipe, seq)`` dp 1 x pp 2 x sp 2 (ring attention,
  dense, L4), ``(gossip, pipe, ep)`` dp 1 x pp 2 x ep 2 and dp 2 x pp 2 x
  ep 2 (MoE, 4 experts on every block, L2; at dp 2 the gossip runs on
  each ``(stage, e)``'s dp group), ``(gossip, pipe, ep, seq)`` dp 1 x pp 2
  x ep 2 x sp 2 (MoE, ring, L2): process ``p = ((replica·pp + s)·ep +
  e)·sp + shard``, the reference's ``make_dp_pp_ep_sp_mesh`` order.  One
  spawn a mesh.
* The LM step (SGP, OSGP at staleness 2, AllReduce), two steps and the
  eval step: losses, ``ppl`` and the eval loss 1e-5 relative, grad norms
  1e-4 relative, params atol 2e-6, momentum atol 4e-6, ``moe_dropped``
  and the push-sum weight exactly, against the stacked replica's (its
  rows, of a stage leaf its stage's slice, of an expert stack its ep
  shard's experts).  Not bit for bit: a process sums its ep shard's
  gradient over the ep group and means its sequence shard's over the sp
  group, where the stack takes one gradient of the mean.  The router's
  top-1/top-2 margin on the first batch is asserted above 1e-6, so the
  routing cannot flip on those differences.  A replica's processes hold
  bit-equal replicated state.
* The ticks: every process logs each hand-off, ring shift and ep exchange
  of its first step and of the eval, in order.  The processes of one
  stage (every sequence and ep shard) log the same sequence; a tick runs
  shifts or exchanges exactly when it is live for the stage (``0 <= t -
  s < n_micro``), in the forward and, in reverse tick order, in the
  backward: bubble ticks run no body and no collective.  The counters
  (shifts, exchanges and their bytes) are the logged calls'.
* The command line under a torchrun environment on the 4-D mesh: every
  collective recorded by its caller's class (hand-offs and the sums over
  stages on the pipe group, shifts and the sequence mean on the sp group,
  exchanges and the ep means on the ep group, metric means on the dp
  group, agreement on the world); checkpoints through the DCP backend
  (forced, logged), an expert stack written as its logical ``[dp, L, E,
  ...]`` rows, the router as ``[dp, L, D, E]``, a replicated leaf once;
  a resume from the step-2 save to step 3 leaves the same checkpoint,
  bit for bit, as the run that went on; every process's CSV carries
  ``moe_dropped`` and the stacked run's rows to one unit of their last
  printed digit.

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

from stochastic_gradient_push_torch.models.convert import (
    init_params, params_from_jax)
from stochastic_gradient_push_torch.models.transformer import TransformerLM
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import StackedEp, is_expert
from stochastic_gradient_push_torch.parallel.mesh import make_dp_sp_layout
from stochastic_gradient_push_torch.parallel.pipeline import StackedPipe
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.train.pp import is_stage
import torch_pp_drive as drive
from test_torch_tp_dist import _dcp
from torch_launch import torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LOSS_RTOL, GN_RTOL, PARAM_ATOL, MOM_ATOL = 1e-5, 1e-4, 2e-6, 4e-6
MARGIN = 1e-6
PP = 2
ALGORITHMS = ("sgp", "osgp", "allreduce")
# (dp, ep, sp) -> (n_layers, moe)
MESHES = {(1, 1, 2): (4, False),     # (gossip, pipe, seq)
          (1, 2, 1): (2, True),      # (gossip, pipe, ep)
          (2, 2, 1): (2, True),      # (gossip, pipe, ep) at dp 2
          (1, 2, 2): (2, True)}      # (gossip, pipe, ep, seq)
HAND_OFF, SHIFT, EXCHANGE = 0, 1, 2

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
from stochastic_gradient_push_torch.parallel.pipeline import DistPipe
from stochastic_gradient_push_torch.parallel.seq import DistSeq
import torch_pp_drive as drive

rank, job = int(sys.argv[3]), json.loads(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo")
world = dist.get_world_size()
dp, ep, sp = job["mesh"]
layout = make_dp_sp_layout(world, sp, 1, ep, job["pp"])
groups = join_groups(layout, rank)
transport = DistTransport(group=groups.dp, siblings=layout.all_dp_members())

# every hand-off, shift and exchange in call order: (kind, backward,
# bytes); the backward is autograd.grad's call
events, phase = [], [0]
grad = torch.autograd.grad

def in_backward(*a, **k):
    phase[0] = 1
    try:
        return grad(*a, **k)
    finally:
        phase[0] = 0

torch.autograd.grad = in_backward

def logged(cls, name, kind):
    fn = getattr(cls, name)
    def wrapped(self, x, *a):
        events.append((kind, phase[0], x.numel() * x.element_size()))
        return fn(self, x, *a)
    setattr(cls, name, wrapped)

logged(DistPipe, "_exchange", 0)
logged(DistSeq, "_hop", 1)
logged(DistEp, "_all_to_all", 2)
out = {}
for i, name in enumerate(job["algorithms"]):
    pipe = DistPipe(DistTransport(group=groups.pp))
    seq = DistSeq(DistTransport(group=groups.sp)) if sp > 1 else None
    ax = DistEp(DistTransport(group=groups.ep)) if ep > 1 else None
    del events[:]
    got = drive.run(name, dp, transport, pipe,
                    drive.batches(dp, ep, sp, job["seed"]),
                    n_layers=job["n_layers"], sp=sp, seq=seq, ep=ax,
                    moe=job["moe"])
    out.update({f"{name}/{k}": v for k, v in got.items()})
    if i == 0:
        out["events"] = np.array(events, dtype=np.int64).reshape(-1, 3)
        out["counters"] = np.array([
            pipe.hand_offs, pipe.hand_off_bytes,
            0 if seq is None else seq.shifts,
            0 if seq is None else seq.shift_bytes,
            0 if ax is None else ax.exchanges,
            0 if ax is None else ax.exchange_bytes,
            pipe.hand_off_s > 0, seq is None or seq.shift_s > 0,
            ax is None or ax.exchange_s > 0])
out["place"] = np.array([*layout.grid(rank), layout.stage(rank),
                         transport.rank, pipe.stages[0],
                         0 if seq is None else seq.shards[0],
                         0 if ax is None else ax.shards[0]])
np.savez(job["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _world(mesh) -> int:
    dp, ep, sp = mesh
    return dp * PP * ep * sp


def _spawn(mesh, tmp) -> list[dict]:
    n_layers, moe = MESHES[mesh]
    job = {"mesh": list(mesh), "pp": PP, "seed": 5, "n_layers": n_layers,
           "moe": moe, "algorithms": list(ALGORITHMS),
           "out": str(tmp / "rank%d.npz")}
    world = _world(mesh)
    torchrun(world, lambda r: [sys.executable, "-c", _WORKER, REPO, TESTS,
                               str(r), json.dumps(job)])
    return [dict(np.load(job["out"] % r)) for r in range(world)]


def _stacked(mesh, name) -> dict:
    dp, ep, sp = mesh
    n_layers, moe = MESHES[mesh]
    return drive.run(name, dp, StackedTransport(dp), StackedPipe(PP),
                     drive.batches(dp, ep, sp, 5), n_layers=n_layers, sp=sp,
                     seq=StackedSeq(sp) if sp > 1 else None,
                     ep=StackedEp(ep) if ep > 1 else None, moe=moe)


@pytest.fixture(scope="module", params=list(MESHES), ids=lambda m: (
    "dp{}_pp2_ep{}_sp{}".format(*m)))
def lanes(request, tmp_path_factory):
    torch.set_num_threads(1)
    mesh = request.param
    rows = _spawn(mesh, tmp_path_factory.mktemp("ppmesh"))
    return mesh, rows, {name: _stacked(mesh, name) for name in ALGORITHMS}


def _margin(mesh) -> float:
    """The smallest top-1 / top-2 router probability gap over the first
    batch's tokens at the start parameters, over every MoE block (the
    logical model on each replica and ep shard's whole sequences: a
    token's probabilities do not depend on how its sequence is cut)."""
    dp, ep, sp = mesh
    n_layers, _ = MESHES[mesh]
    cfg = drive.config(n_layers, moe=True)
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(init_params(cfg, 0)))
    seen = []
    for i in range(n_layers):
        getattr(model, f"block_{i}").moe.register_forward_hook(
            lambda mod, args, out: seen.append(args[0] @ mod.router))
    toks = drive.batches(dp, ep, sp, 5)[0][0]
    with torch.no_grad():
        for r, e in np.ndindex(dp, ep):
            x = np.concatenate(list(toks[r, e]), axis=-1)
            model(torch.from_numpy(x).long())
    top = torch.cat([torch.softmax(z, -1).reshape(-1, z.shape[-1])
                     for z in seen]).topk(2, -1).values
    return float((top[:, 0] - top[:, 1]).min())


def _mine(mesh, p, key, stacked):
    """The stacked run's slice process ``p`` holds: its replica's rows,
    of a stage leaf its stage's, of an expert stack its experts."""
    dp, ep, sp = mesh
    layout = make_dp_sp_layout(_world(mesh), sp, 1, ep, PP)
    replica, e, _, _ = layout.grid(p)
    w = stacked[replica:replica + 1]
    part, name = key.split("/", 1)[0], key.split("/", 1)[-1]
    if part in ("params", "momentum") and is_stage(name):
        s = layout.stage(p)
        w = w[:, s:s + 1]
        if ep > 1 and is_expert(name):
            w = np.split(w, ep, axis=-3)[e]
    return w


def test_processes_sit_on_the_reference_grid(lanes):
    mesh, rows, _ = lanes
    dp, ep, sp = mesh
    layout = make_dp_sp_layout(_world(mesh), sp, 1, ep, PP)
    for p, row in enumerate(rows):
        replica, e, shard, _ = layout.grid(p)
        s = layout.stage(p)
        assert p == ((replica * PP + s) * ep + e) * sp + shard
        # the dp transport's rank is the replica; DistPipe, DistSeq and
        # DistEp hold the process's stage, shard and ep shard
        assert list(row["place"]) == [replica, e, shard, 0, s, replica, s,
                                      shard, e]


@pytest.mark.parametrize("name", ALGORITHMS)
def test_lm_step_against_the_stack(lanes, name):
    mesh, rows, want = lanes
    dp, ep, sp = mesh
    stacked = want[name]
    layout = make_dp_sp_layout(_world(mesh), sp, 1, ep, PP)
    if MESHES[mesh][1]:
        assert _margin(mesh) > MARGIN
        # the routing dropped tokens: each microbatch's capacity is real
        assert float(stacked["moe_dropped/0"].max()) > 0
    for p, row in enumerate(rows):
        replica, e, shard, _ = layout.grid(p)
        first = layout.proc(replica, 0, 0, 0, layout.stage(p))
        for k, w in stacked.items():
            part, leaf = k.split("/", 1)[0], k.split("/")[-1]
            if part in ("hand_offs", "shifts", "shift_bytes", "exchanges",
                        "exchange_bytes"):
                continue
            g = row[f"{name}/{k}"]
            if part in ("params", "momentum") and not is_expert(leaf):
                # a stage's replicated state is the same on every
                # sequence and ep shard of its replica
                np.testing.assert_array_equal(g, rows[first][f"{name}/{k}"],
                                              err_msg=k)
            w = _mine(mesh, p, k, w)
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if part in ("ps_weight", "moe_dropped"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif part in ("loss", "ppl", "eval_loss"):
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif part == "grad_norm":
                np.testing.assert_allclose(g, w, rtol=GN_RTOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=PARAM_ATOL if part == "params"
                    else MOM_ATOL, err_msg=k)


def _ticks(kinds) -> list[list[int]]:
    """A forward's (or a backward's) calls cut at its hand-offs: each
    tick's shifts and exchanges."""
    ticks = [[]]
    for k in kinds:
        if k == HAND_OFF:
            ticks.append([])
        else:
            ticks[-1].append(int(k))
    return ticks


def test_bubble_ticks_run_no_collective(lanes):
    mesh, rows, _ = lanes
    dp, ep, sp = mesh
    n_ticks = drive.N_MICRO + PP - 1
    layout = make_dp_sp_layout(_world(mesh), sp, 1, ep, PP)
    for p, row in enumerate(rows):
        ev = row["events"]
        s = layout.stage(p)
        # every process of the stage runs the same calls, in one order
        for q in range(len(rows)):
            if layout.stage(q) == s:
                np.testing.assert_array_equal(ev, rows[q]["events"])
        # the first step's forward and backward, then the second's, then
        # the eval's forward: five runs of one phase
        cuts = np.flatnonzero(np.diff(ev[:, 1])) + 1
        runs = np.split(ev[:, 0], cuts)
        assert len(runs) == 5 and list(ev[cuts, 1]) == [1, 0, 1, 0]
        for i, kinds in enumerate(runs):
            ticks = _ticks(kinds)
            assert len(ticks) == n_ticks, (p, i)
            if i in (1, 3):
                ticks = ticks[::-1]   # the backward runs the ticks in reverse
            for t, calls in enumerate(ticks):
                live = 0 <= t - s < drive.N_MICRO
                assert bool(calls) == live, (p, i, t, calls)
        # the counters are the logged calls'
        c = row["counters"]
        for kind, (n, nbytes) in ((HAND_OFF, c[0:2]), (SHIFT, c[2:4]),
                                  (EXCHANGE, c[4:6])):
            mine = ev[ev[:, 0] == kind]
            assert n == len(mine) and nbytes == mine[:, 2].sum(), kind
        assert len(ev[ev[:, 0] == SHIFT]) > 0 or sp == 1
        assert len(ev[ev[:, 0] == EXCHANGE]) > 0 or ep == 1
        assert all(c[6:]), c


# -- the command line on (gossip, pipe, ep, seq) ----------------------------

_CLI_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = {("DistPipe", "_exchange"), ("DistPipe", "sum_stages"),
       ("DistEp", "_all_to_all"), ("DistEp", "reduce_grads"),
       ("DistEp", "pmean"), ("DistSeq", "_hop"), ("DistSeq", "pmean"),
       (None, "mean"), (None, "any_process"),
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

DP, EP, SP = 1, 2, 2
WORLD = DP * PP * EP * SP
E = drive.E
ARGV = ["--device", "cpu", "--moe_experts", str(E), "--moe_every", "1",
        "--ep", str(EP), "--sp", str(SP), "--pp", str(PP), "--n_micro",
        "2", "--attn", "ring", "--vocab_size", "64", "--d_model", "16",
        "--n_layers", "2", "--n_heads", "4", "--d_ff", "32", "--seq_len",
        "16", "--batch_size", "4", "--print_freq", "1", "--corpus_tokens",
        "2000", "--ckpt_every", "2"]


def _cli(argv: list) -> list[str]:
    return torchrun(WORLD, lambda r: [sys.executable, "-c", _CLI_WORKER,
                                      REPO, json.dumps(argv)])


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
    assert ("--ep 2 under torchrun: checkpoints through --ckpt_backend "
            "orbax") in runs[0][0]
    assert (f"world {WORLD} = dp {DP} x pp {PP} x ep {EP} x sp {SP} "
            f"(process 0: replica 0, stage 0, ep shard 0, shard 0)") in (
        runs[0][0])
    a, b = _dcp(straight / root / "3"), _dcp(split / root / "3")
    assert set(a) == set(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # an expert stack as its logical [dp, L, E, ...] rows (pipe on the
    # layer dim, ep on the expert dim), the router on pipe alone, a
    # replicated leaf once
    assert tuple(a["state.params.stack.moe.experts_up"].shape) == (
        DP, 2, E, 16, 32)
    assert tuple(a["state.params.stack.moe.experts_down"].shape) == (
        DP, 2, E, 32, 16)
    assert tuple(a["state.params.stack.moe.router"].shape) == (DP, 2, 16, E)
    assert tuple(a["state.params.embed.weight"].shape) == (DP, 64, 16)
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
    layout = make_dp_sp_layout(WORLD, SP, 1, EP, PP)
    for p in range(WORLD):
        replica, e, shard, t = layout.grid(p)
        s = layout.stage(p)
        pipe = layout.pp_members(replica, e, shard)
        ep_group = layout.ep_members(replica, shard, t, s)
        sp_group = layout.sp_members(replica, t, e, s)
        group = {"DistPipe._exchange": pipe, "DistPipe.sum_stages": pipe,
                 "DistEp._all_to_all": ep_group,
                 "DistEp.reduce_grads": ep_group, "DistEp.pmean": ep_group,
                 "DistSeq._hop": sp_group, "DistSeq.pmean": sp_group,
                 "mean": layout.dp_members(shard, t, e, s),
                 "any_process": list(range(WORLD)),
                 "consensus_resume_point": list(range(WORLD))}
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert set(group) <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group:
                assert got == group[who], (p, op, who, got)
