"""The sequence axis across processes (``parallel/seq.py::DistSeq``): one
sequence shard a gloo process, held against the stacked lane
(``StackedSeq``, all shards in one process) on the same numpy data, and
once against the reference.

* ``ring_shift`` and its backward in 4 processes: bit-equal to the
  stack's ``torch.roll`` and its transpose.
* ``ring_attention`` and ``ring_flash_attention`` (plain ticks) at sp 4,
  causal and full: outputs and ``dq``/``dk``/``dv`` of ``Σ out·g`` equal
  to the stacked lane's bit for bit (each process runs its shard's row
  of every tick with the stack's operations); the processes' ring_flash
  against the reference's ``ring_flash_attention`` under
  ``jax.jit(shard_map)`` on a 4-device CPU mesh within atol 1e-5, as
  ``test_torch_ring_attention.py`` holds the stack.
* The LM train step at dp 2 x sp 2 (4 processes; SGP, SGP on the gossip
  kernel lane's twin, OSGP at staleness 2, AllReduce) and at dp 1 x sp 4 (``ring``: a ring turned the wrong
  way meets other owners), three steps and the eval step: every shard of
  a replica bit-equal to the others; against the stacked replica the
  push-sum weight and the FIFO's weights exactly, losses 1e-5 relative,
  grad norms 1e-4 relative, params and momentum atol 2e-6 (the stacked
  sp tests' tolerances: the gradient's shard sum runs in another order).
* A grouped mean on each shard index's dp group, bit-equal to the
  stacked transport's.
* The kernel lane's landing blocks are published and looked up under the
  global rank of the process holding a gossip rank.
* The command line at dp 2 x sp 2 with every collective recorded by its
  caller: ring shifts and the loss/gradient mean on the replica's sp
  group, the gossip round, health signals and metric means on the dp
  group, signal and resume agreement on the world.

Children run under ``communicate(timeout=...)`` with one torch thread;
this process is pinned to one thread too.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops.ring_flash import (
    ring_flash_attention)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.mesh import (
    make_dp_sp_layout)
from stochastic_gradient_push_torch.parallel.ring_attention import (
    ring_attention)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
import torch_seq_drive as drive
from torch_launch import spawn, torchrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SP = 4
BLK = (1, 2, 8, 16)    # a shard's q/k/v: [B, H, t, D]
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
ATTN = {"ring": ring_attention,
        "ring_flash": lambda q, k, v, seq, causal: ring_flash_attention(
            q, k, v, seq, causal=causal, lane="plain")}

_WORKER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.ops.ring_flash import (
    ring_flash_attention)
from stochastic_gradient_push_torch.parallel.collectives import (
    DistTransport)
from stochastic_gradient_push_torch.parallel.mesh import (
    join_dp_sp_groups, make_dp_sp_layout)
from stochastic_gradient_push_torch.parallel.ring_attention import (
    ring_attention)
from stochastic_gradient_push_torch.parallel.seq import DistSeq
import torch_seq_drive as drive

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
layout = make_dp_sp_layout(world, job["sp"])
sp_group, dp_group = join_dp_sp_groups(layout, rank)
replica, shard = layout.place(rank)
seq = DistSeq(DistTransport(group=sp_group))
transport = DistTransport(group=dp_group, siblings=[
    layout.dp_members(i) for i in range(job["sp"])])
out = {"place": np.array([replica, shard, seq.shards[0],
                          transport.rank])}
if job["case"] == "attn":
    data = np.load(job["data"])
    x = torch.from_numpy(data["x"][shard:shard + 1]).requires_grad_(True)
    y = seq.ring_shift(x)
    out["shift"] = y.detach().numpy()
    out["shift_grad"] = torch.autograd.grad(
        y, x, torch.from_numpy(data["gx"][shard:shard + 1]))[0].numpy()
    fns = {"ring": ring_attention,
           "ring_flash": lambda q, k, v, seq, causal: ring_flash_attention(
               q, k, v, seq, causal=causal, lane="plain")}
    for impl, fn in fns.items():
        for causal in (True, False):
            q, k, v = (torch.from_numpy(data[n][shard:shard + 1])
                       .requires_grad_(True) for n in "qkv")
            o = fn(q, k, v, seq, causal)
            grads = torch.autograd.grad(
                o, (q, k, v), torch.from_numpy(data["g"][shard:shard + 1]))
            for name, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
                out[f"{impl}/{causal}/{name}"] = t.detach().numpy()
else:
    # a grouped mean over the whole dp group: its subgroups are made for
    # every shard index's dp group, in one order in every process
    rows = np.arange(layout.dp * 6, dtype=np.float32).reshape(layout.dp, 6)
    out["group_mean"] = transport.group_mean(
        [torch.from_numpy(rows[replica:replica + 1] + shard)],
        [list(range(layout.dp))])[0].numpy()
    data = drive.batches(layout.dp, job["sp"], job["seed"])
    for name in job["algorithms"]:
        got = drive.run(name, layout.dp, transport, seq, data,
                        impl=job["impl"])
        out.update({f"{name}/{k}": v for k, v in got.items()})
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


# -- ring shift and attention, sp 4 -------------------------------------------


@pytest.fixture(scope="module")
def attn_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attn")
    r = np.random.default_rng(11)
    data = {n: r.normal(size=(SP, *BLK)).astype(np.float32)
            for n in ("q", "k", "v", "g", "x", "gx")}
    np.savez(tmp / "data.npz", **data)
    rows = _spawn(SP, {"case": "attn", "sp": SP,
                       "data": str(tmp / "data.npz")}, tmp)
    return data, rows


def _stacked(fn, data, causal):
    q, k, v = (torch.from_numpy(data[n]).requires_grad_(True)
               for n in "qkv")
    o = fn(q, k, v, StackedSeq(SP), causal)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(data["g"]))
    return [t.detach().numpy() for t in (o, *grads)]


def test_processes_take_the_reference_device_order(attn_data):
    """Process p holds shard p % sp of replica p // sp; its DistSeq and
    its dp transport say so."""
    _, rows = attn_data
    for p, row in enumerate(rows):
        replica, shard = divmod(p, SP)
        assert row["place"].tolist() == [replica, shard, shard, replica]


def test_ring_shift_and_its_backward_equal_the_stack(attn_data):
    data, rows = attn_data
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    y = StackedSeq(SP).ring_shift(x)
    gx = torch.autograd.grad(y, x, torch.from_numpy(data["gx"]))[0]
    got = np.concatenate([r["shift"] for r in rows])
    got_g = np.concatenate([r["shift_grad"] for r in rows])
    np.testing.assert_array_equal(got, y.detach().numpy())
    np.testing.assert_array_equal(got_g, gx.numpy())
    # shard i's block went to i + 1, its gradient came back from i + 1
    np.testing.assert_array_equal(got[1], data["x"][0])
    np.testing.assert_array_equal(got_g[0], data["gx"][1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_ring_attention_across_processes_equals_the_stack(attn_data, impl,
                                                          causal):
    data, rows = attn_data
    want = _stacked(ATTN[impl], data, causal)
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"{impl}/{causal}/{name}"] for r in rows])
        np.testing.assert_array_equal(got, w, err_msg=name)


def test_ring_flash_across_processes_matches_the_reference(attn_data):
    """The processes' plain-tick ring_flash against the reference's under
    ``jax.jit(shard_map)``, one shard a device of a 4-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.ops.ring_flash import (
        ring_flash_attention as jring_flash)
    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh

    data, rows = attn_data

    def f(qb, kb, vb, gb):
        def loss(q, k, v):
            out = jring_flash(q, k, v, "gossip", causal=True,
                              use_pallas=False)
            return jnp.sum(out * gb[0]), out

        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(qb[0], kb[0], vb[0])
        return (out[None],) + tuple(x[None] for x in grads)

    want = jax.jit(jax.shard_map(
        f, mesh=make_gossip_mesh(SP), in_specs=(P("gossip"),) * 4,
        out_specs=(P("gossip"),) * 4))(*(data[n] for n in "qkvg"))
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"ring_flash/True/{name}"] for r in rows])
        np.testing.assert_allclose(got, np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)


# -- the LM step ---------------------------------------------------------------


def _lm_rows(dp, sp, impl, algorithms, seed, tmp):
    rows = _spawn(dp * sp, {"case": "lm", "sp": sp, "seed": seed,
                            "impl": impl, "algorithms": list(algorithms)},
                  tmp)
    want = {}
    for name in algorithms:
        got = drive.run(name, dp, StackedTransport(dp), StackedSeq(sp),
                        drive.batches(dp, sp, seed), impl=impl)
        want.update({f"{name}/{k}": v for k, v in got.items()})
    return rows, want


@pytest.fixture(scope="module")
def lm_dp2_sp2(tmp_path_factory):
    return _lm_rows(2, 2, "ring_flash", drive.ALGORITHMS, 5,
                    tmp_path_factory.mktemp("lm22"))


@pytest.fixture(scope="module")
def lm_dp1_sp4(tmp_path_factory):
    return _lm_rows(1, 4, "ring", ("sgp",), 9,
                    tmp_path_factory.mktemp("lm14"))


def _assert_lm(rows, want, name, sp):
    layout = make_dp_sp_layout(len(rows), sp)
    keys = [k for k in want if k.startswith(name + "/")]
    for p, row in enumerate(rows):
        replica, shard = layout.place(p)
        # every shard of a replica holds the same state, bit for bit
        first = rows[layout.sp_members(replica)[0]]
        for k in keys:
            np.testing.assert_array_equal(row[k], first[k], err_msg=k)
        for k in keys:
            w, g = want[k][replica:replica + 1], row[k]
            if k.split("/")[1] in ("ps_weight", "in_flight"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif k.split("/")[1] in ("loss", "eval_loss"):
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif k.split("/")[1] == "grad_norm":
                np.testing.assert_allclose(g, w, rtol=GN_RTOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                           err_msg=k)


@pytest.mark.parametrize("name", drive.ALGORITHMS)
def test_lm_step_dp2_sp2_across_processes_equals_the_stack(lm_dp2_sp2,
                                                           name):
    rows, want = lm_dp2_sp2
    _assert_lm(rows, want, name, 2)


def test_lm_step_dp1_sp4_ring_direction(lm_dp1_sp4):
    """One replica's ring of 4 processes with the plain ``ring``: causal
    masks see owners 0..i in shard i only when the blocks travel i -> i+1;
    the losses, gradients and params equal the stack's."""
    rows, want = lm_dp1_sp4
    _assert_lm(rows, want, "sgp", 4)


def test_group_mean_runs_on_each_shard_index_dp_group(lm_dp2_sp2):
    """``DistTransport.group_mean`` on a dp group (a hierarchical or
    synthesized round's grouped mean): each shard index's replicas mean
    their own rows, bit-equal to the stacked transport's mean."""
    rows, _ = lm_dp2_sp2
    base = np.arange(12, dtype=np.float32).reshape(2, 6)
    for p, row in enumerate(rows):
        shard = p % 2
        want = StackedTransport(2).group_mean(
            [torch.from_numpy(base + shard)], [[0, 1]])[0]
        np.testing.assert_array_equal(row["group_mean"],
                                      want[p // 2:p // 2 + 1].numpy())


def test_eval_step_loss_across_processes(lm_dp2_sp2):
    rows, want = lm_dp2_sp2
    for p, row in enumerate(rows):
        replica = p // 2
        np.testing.assert_allclose(
            row["sgp/eval_loss"], want["sgp/eval_loss"][replica:replica + 1],
            rtol=LOSS_RTOL, atol=0)


def test_peer_links_name_a_gossip_rank_by_its_process():
    """Gossip rank r of a dp group is the process members[r]: its block's
    handle sits under that process's key, so the dp groups of the other
    shard indices, running side by side, never map it."""
    from stochastic_gradient_push_torch.ops.gossip_kernel import PeerLinks

    layout = make_dp_sp_layout(8, 4)
    keys = {}
    for shard in range(4):
        links = PeerLinks(0, 2, members=layout.dp_members(shard))
        keys[shard] = [links.handle_key("link", r) for r in range(2)]
    assert keys[1] == ["link/1", "link/5"]
    assert len({k for ks in keys.values() for k in ks}) == 8
    assert PeerLinks(1, 4).handle_key("link", 3) == "link/3"
    with pytest.raises(ValueError, match="3 members for a group of 2"):
        PeerLinks(0, 2, members=[0, 1, 2])


# -- which group each collective of the command line runs on ----------------

_CLI_WORKER = r"""
import json, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist

WHO = ("_hop", "pmean", "mean", "any_process", "consensus_resume_point",
       "health_signals", "post_step", "reduce_grads", "global_average",
       "leave", "close")
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
dist.barrier = spy("barrier", dist.barrier, lambda a, k: k.get("group"))
from stochastic_gradient_push_torch.run import gossip_lm
try:
    gossip_lm.main(json.loads(sys.argv[2]))
finally:
    print("CALLS " + json.dumps(calls), flush=True)
"""


def test_cli_collectives_run_on_their_groups(tmp_path):
    world, sp = 4, 2
    argv = ["--device", "cpu", "--sp", str(sp), "--attn", "ring",
            "--vocab_size", "64", "--d_model", "16", "--n_layers", "1",
            "--n_heads", "1", "--d_ff", "32", "--seq_len", "16",
            "--batch_size", "2", "--num_steps", "2", "--print_freq", "1",
            "--corpus_tokens", "2000", "--health_every", "1",
            "--checkpoint_dir", str(tmp_path)]
    runs = []
    for resume, steps in (("False", "2"), ("True", "3")):
        logs = torchrun(world, lambda r: [
            sys.executable, "-c", _CLI_WORKER, REPO,
            json.dumps(argv + ["--resume", resume, "--num_steps", steps])],
            PYTHONPATH=REPO)
        assert "resumed from step 2" in logs[0] or resume == "False"
        runs.append(logs)
    layout = make_dp_sp_layout(world, sp)
    sp_of = {p: layout.sp_members(p // sp) for p in range(world)}
    dp_of = {p: layout.dp_members(p % sp) for p in range(world)}
    group = {"_hop": sp_of, "pmean": sp_of, "mean": dp_of,
             "post_step": dp_of, "health_signals": dp_of,
             "any_process": {p: list(range(world)) for p in range(world)},
             "consensus_resume_point": {p: list(range(world))
                                        for p in range(world)}}
    for p in range(world):
        calls = [c for logs in runs for c in json.loads(next(
            ln for ln in logs[p].splitlines() if ln.startswith("CALLS "))[6:])]
        seen = {who for _, who, _ in calls}
        assert set(group) <= seen, sorted(seen)
        for op, who, got in calls:
            if who in group:
                assert got == group[who][p], (p, op, who, got)
