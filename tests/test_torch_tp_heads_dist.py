"""Heads that straddle tp shards, one tp shard a gloo process
(``parallel/tp.py::DistTp``), held against the stacked lane
(``StackedTp``) on the same numpy data, at the reference's
command-line shapes (``n_heads 3, d_model 24``: a shard's 12 or 6
columns cut a head of 8).

A process holds only its ``d_model / tp`` columns of q, k and v and its
rows of ``o``: no process holds a replica of the attention's weights.
It gathers the columns of the heads its own touch over its tp group and
runs the attention on them; a shared head's gradient is each holder's
partial sum, folded in shard order (``_HeadGather``).  So the processes
are not bit-equal to the stack, which takes a shared head's gradient in
one backward: two steps and the eval step sit within ``test_torch_tp.
py``'s tolerances of the stack (losses and the eval loss 1e-5 relative,
grad norms 1e-4 relative, params and momentum atol 2e-6, the push-sum
weight exactly).  The meshes: ``(gossip, tp)`` at dp 2 x tp 2 (SGP) and
at dp 1 x tp 4 (fewer heads than shards; flash's plain twin, remat,
OSGP), ``(gossip, seq, tp)`` at sp 2 x tp 2 (ring) and ``(gossip, ep,
tp)`` at ep 2 x tp 2 (switch MoE), four processes each.

Children run under ``communicate(timeout=...)`` with one torch thread;
this process is pinned to one thread too.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel.ep import StackedEp, is_expert
from stochastic_gradient_push_torch.parallel.mesh import make_dp_sp_layout
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import StackedTp, split_dim
from stochastic_gradient_push_torch.train import lm as tlm
import torch_ep_drive as ep_drive
import test_torch_tp_heads as heads
from torch_launch import spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
SEED = 29

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
import torch_ep_drive as ep_drive
import test_torch_tp_heads as heads

rank, world, port = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
job = json.loads(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
sp, tp, ep = job["sp"], job["tp"], job["ep"]
layout = make_dp_sp_layout(world, sp, tp, ep)
groups = join_groups(layout, rank)
transport = DistTransport(group=groups.dp, siblings=layout.all_dp_members())
seq = DistSeq(DistTransport(group=groups.sp)) if sp > 1 else None
dep = DistEp(DistTransport(group=groups.ep)) if ep > 1 else None
dtp = DistTp(DistTransport(group=groups.tp))
cfg = heads.config(tp, job["h"], job["d"], job["impl"], job["experts"], ep,
                   remat=job["remat"])
data = ep_drive.batches(layout.dp, ep, sp, job["seed"], steps=heads.STEPS)
out = heads.port_run(cfg, layout.dp, sp, data, transport=transport,
                     seq=seq, tp=dtp, ep=dep, name=job["name"])
out["place"] = np.array([*layout.grid(rank), transport.rank,
                         dtp.shards[0]])
np.savez(job["out"] % rank, **out)
dist.barrier()
dist.destroy_process_group()
"""

# (dp, sp, ep, tp, impl, remat, algorithm, experts)
CASES = {
    "dp2_tp2": (2, 1, 1, 2, "full", False, "sgp", 0),
    "dp1_tp4_flash_remat_osgp": (1, 1, 1, 4, "flash", True, "osgp", 0),
    "sp2_tp2_ring": (1, 2, 1, 2, "ring", False, "sgp", 0),
    "ep2_tp2_moe": (1, 1, 2, 2, "full", False, "sgp", 2),
}
H, D = 3, 24


@pytest.mark.parametrize("case", sorted(CASES))
def test_processes_hold_their_columns_and_match_the_stack(tmp_path, case):
    dp, sp, ep, tp, impl, remat, name, experts = CASES[case]
    world = dp * sp * ep * tp
    job = {"sp": sp, "tp": tp, "ep": ep, "h": H, "d": D, "impl": impl,
           "remat": remat, "name": name, "experts": experts, "seed": SEED,
           "out": str(tmp_path / "rank%d.npz")}
    spawn(world, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, TESTS, str(r), str(world),
        str(port), json.dumps(job)], PYTHONPATH=REPO)
    rows = [dict(np.load(job["out"] % r)) for r in range(world)]
    data = ep_drive.batches(dp, ep, sp, SEED, steps=heads.STEPS)
    cfg = heads.config(tp, H, D, impl, experts, ep, remat=remat)
    want = heads.port_run(cfg, dp, sp, data,
                          seq=StackedSeq(sp) if sp > 1 else None,
                          tp=StackedTp(tp),
                          ep=StackedEp(ep) if ep > 1 else None, name=name)
    layout = make_dp_sp_layout(world, sp, tp, ep)
    shapes = tlm.logical_shapes(heads.config(1, H, D, impl, experts))
    for p, row in enumerate(rows):
        replica, e, s, t = layout.grid(p)
        assert row["place"].tolist() == [replica, e, s, t, replica, t]
        for k, w in want.items():
            w = w[replica:replica + 1]
            part, _, leaf = k.partition("/")
            if part in ("params", "momentum"):
                if ep > 1 and is_expert(leaf):
                    # [R, tp, E, ...]: this ep shard's experts
                    n = experts // ep
                    w = w[:, :, e * n:(e + 1) * n]
                if split_dim(leaf) is not None:
                    w = w[:, t:t + 1]
            g = row[k]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if part == "ps_weight":
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif part == "moe_dropped":
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif part in ("loss", "ppl", "eval_loss"):
                np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0,
                                           err_msg=k)
            elif part == "grad_norm":
                np.testing.assert_allclose(g, w, rtol=GN_RTOL, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                           err_msg=k)
        # q/k/v hold this process's d_model / tp columns, o its rows
        for n, shape in shapes.items():
            if split_dim(n) is not None and not is_expert(n):
                got = row[f"params/{n}"]
                assert got.shape[:2] == (1, 1)
                assert got.size * tp == int(np.prod(shape)), n
        for mod in ("q", "k", "v"):
            assert row[f"params/block_0.attn.{mod}.weight"].shape == (
                1, 1, D // tp, D)
        assert row["params/block_0.attn.o.weight"].shape == (1, 1, D,
                                                              D // tp)
