"""MoE and expert parallelism on the stacked lane (``parallel/ep.py::
StackedEp``, a replica's ``ep`` shards in one process), held against the
reference's ``build_lm_train_step`` on its CPU meshes
(``make_dp_ep_mesh``, ``make_dp_ep_sp_mesh``; at ep 1 the flat and
``(gossip, seq)`` meshes), weights carried across by
``train_state_from_jax``, at ``tests/test_expert_parallel_lm.py``'s
sizes (d32, L2, h4, ff32, 8 experts on block 1, T32, B2).

* **Two steps against the reference** at dp 2 x ep {1, 2} x sp {1, 2},
  SGP: losses and ``ppl`` 1e-5 relative, ``moe_dropped`` exactly (the
  routing is the reference's), grad norms 1e-4 relative, params atol
  2e-6, momentum ``MOM_ATOL`` (4e-6), the push-sum weight exactly; the
  two frameworks differ only in the order of fp32 sums (they sit ~1e-7
  apart in the params, ~1e-6 in the momentum).  Also AllReduce at dp 1,
  the int8 wire, and ``grad_accum`` 2 (each microbatch routes under its
  own capacity).
* **The ``/n_ep`` oracle** (the reference's
  ``test_ep_train_step_matches_full_expert_model``): one momentum-free
  AllReduce step at dp 1 x ep 2, capacity factor 8, no MoE loss, moves
  every parameter, expert slices included, by ``-lr ·`` the gradient of
  the ep 1 model's mean cross-entropy over both shards' tokens, within
  the reference test's rtol 5e-4 / atol 1e-5.
* **The int8 wire**: a round on the stacked logical expert leaves equals
  the reference's compiled round on its ``(gossip, ep)`` mesh, where each
  shard blocks its local slice, bit for bit; a block that a shard's
  slice would cut is refused naming the leaf.
* **Checkpoints**: the stacked files hold the logical leaves; a run
  resumed from them equals one that never stopped.
* **The command line**: ``--moe_experts``/``--ep`` train, the CSV gains
  ``moe_dropped``, and every reference refusal fires with its message.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    train_state_from_jax)
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import (
    StackedEp, check_ep_wire_blocks, gather_experts, is_expert,
    shard_experts)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
import torch_ep_drive as drive
import torch_lm_drive as lm_drive

LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_steps(dp, ep, sp, data, start, name="sgp", grad_accum=1):
    cfg = drive.config(ep, "ring" if sp > 1 else "full")
    alg = drive.algorithm(name, dp, StackedTransport(dp))
    step = tlm.build_lm_train_step(
        tlm.make_model(cfg), alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.5, drive.B, dp * ep, decay_schedule={}, warmup=True),
        itr_per_epoch=2, grad_accum=grad_accum,
        seq=StackedSeq(sp) if sp > 1 else None,
        ep=StackedEp(ep) if ep > 1 else None)
    state = train_state_from_jax(start)
    metrics = []
    for x, y in data:
        xs = [drive.local(a, range(dp), range(ep), sp) for a in (x, y)]
        if ep == 1:
            xs = [a[:, 0] for a in xs]
        state, m = step(state, *xs)
        metrics.append(m)
    return state, metrics


def _assert_matches(state, metrics, end, want_metrics):
    for m, want in zip(metrics, want_metrics):
        for k, rtol in (("loss", LOSS_RTOL), ("ppl", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(m[k].numpy(),
                                       np.asarray(want[k]).reshape(-1),
                                       rtol=rtol, atol=0, err_msg=k)
        assert np.array_equal(m["moe_dropped"].numpy(),
                              np.asarray(want["moe_dropped"]).reshape(-1))
    ref = train_state_from_jax(end)
    for n, w in ref.params.items():
        np.testing.assert_allclose(state.params[n].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=n)
        np.testing.assert_allclose(state.opt_state[n].numpy(),
                                   ref.opt_state[n].numpy(), rtol=0,
                                   atol=lm_drive.MOM_ATOL, err_msg=n)
    assert torch.equal(state.gossip.ps_weight, ref.gossip.ps_weight)


@pytest.mark.parametrize("dp,ep,sp,name,grad_accum", [
    (2, 2, 1, "sgp", 1),       # (gossip, ep)
    (2, 2, 2, "sgp", 1),       # (gossip, ep, seq), ring
    (2, 1, 1, "sgp", 1),       # MoE on the flat dp mesh
    (2, 1, 2, "sgp", 1),       # MoE x ring: per-block routing
    (1, 2, 1, "allreduce", 1),
    (2, 2, 1, "sgp_int8", 1),
    (2, 2, 1, "sgp", 2),       # per-microbatch capacity
])
def test_steps_match_the_reference(dp, ep, sp, name, grad_accum):
    data = drive.batches(dp, ep, sp, 3)
    start, end, want = drive.jax_run(dp, ep, sp, data, name,
                                     grad_accum=grad_accum)
    state, metrics = _port_steps(dp, ep, sp, data, start, name, grad_accum)
    # the routing dropped tokens: the capacity is really exercised
    assert float(metrics[0]["moe_dropped"].max()) > 0
    _assert_matches(state, metrics, end, want)


def test_grad_accum_routes_each_microbatch_alone():
    """``grad_accum`` 2 routes each half batch under its own capacity,
    so its dropped fraction is not the full batch's (and the reference's
    is the same, above)."""
    data = drive.batches(2, 2, 1, 3)
    got = [float(_port_steps(2, 2, 1, data[:1], drive.jax_run(
        2, 2, 1, data[:1], grad_accum=1)[0], grad_accum=g)[1][0][
        "moe_dropped"].sum()) for g in (1, 2)]
    assert got[0] != got[1]


def test_each_ep_shard_scales_its_gradient_by_n_ep():
    """One momentum-free AllReduce step at dp 1 x ep 2 (capacity factor
    8: nothing dropped; no MoE loss) against ``p - lr · grad`` of the ep 1
    model on both shards' tokens (their mean cross-entropy): the expert
    slices get every shard's cotangents, and are divided by ep like the
    rest."""
    from torch.func import functional_call

    ep = 2
    cfg = drive.config(ep, cf=8.0, experts=4)
    model = tlm.make_model(cfg)
    alg = talg.all_reduce(StackedTransport(1))
    tx = sgd(momentum=0.0, weight_decay=0.0)
    step = tlm.build_lm_train_step(
        model, alg, tx, LRSchedule(0.1, drive.B, ep, decay_schedule={},
                                   warmup=False),
        itr_per_epoch=100, ep=StackedEp(ep), moe_loss_coef=0.0)
    state = tlm.init_lm_state(cfg, alg, tx, 1, seed=3, ep=StackedEp(ep))
    rng = np.random.default_rng(7)
    toks, tgts = (torch.from_numpy(rng.integers(
        0, drive.VOCAB, size=(1, ep, drive.B, drive.T))) for _ in range(2))
    p0 = {n: p[0].clone().requires_grad_(True)
          for n, p in state.params.items()}
    ref_model = tlm.make_model(drive.config(1, cf=8.0, experts=4))
    loss = torch.stack([tlm.lm_loss(functional_call(ref_model, p0,
                                                    (toks[0, j],)),
                                    tgts[0, j]) for j in range(ep)]).mean()
    grads = dict(zip(p0, torch.autograd.grad(loss, list(p0.values()))))
    new, m = step(state, toks, tgts)
    assert float(m["moe_dropped"][0]) == 0.0
    lr = float(m["lr"])
    for n, p in p0.items():
        want = p.detach() - lr * grads[n]
        assert float((new.params[n][0] - p.detach()).abs().max()) > 0, n
        np.testing.assert_allclose(new.params[n][0].numpy(), want.numpy(),
                                   rtol=5e-4, atol=1e-5, err_msg=n)


# -- the int8 wire ---------------------------------------------------------


@pytest.mark.parametrize("phase", [0, 1])
def test_int8_round_on_expert_leaves_is_the_references(phase):
    """The stacked lane's int8 round over the logical expert leaves
    ``[dp, E, D, F]`` equals the reference's compiled round on its
    ``(gossip, ep)`` mesh, each shard encoding its local slice, bit for
    bit (expert and replicated leaves, and the push-sum weight)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.wire import (
        get_codec as jcodec)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train.lm import (
        EP_AXIS, make_dp_ep_mesh)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS

    dp, ep, block = 4, 2, 64
    cfg = drive.config(ep)
    shapes = {n: s for n, s in tlm.logical_shapes(cfg).items()
              if is_expert(n) or n.endswith("moe.router")}
    rng = np.random.default_rng(9)
    params = {n: rng.normal(size=(dp, *s)).astype(np.float32)
              for n, s in shapes.items()}
    weight = (1.0 + rng.random(dp)).astype(np.float32)
    jsched = jbuild(JGraph(dp, peers_per_itr=1))
    specs = {n: P(GOSSIP_AXIS, EP_AXIS) if is_expert(n) else P(GOSSIP_AXIS)
             for n in params}

    def body(p, w):
        return mix_push_sum(p, w, jnp.int32(phase), jsched, GOSSIP_AXIS,
                            codec=jcodec("int8", block))

    want_p, want_w = jax.jit(jax.shard_map(
        body, mesh=make_dp_ep_mesh(dp, ep), in_specs=(specs, P(GOSSIP_AXIS)),
        out_specs=(specs, P(GOSSIP_AXIS))))(params, weight)
    from stochastic_gradient_push_torch.parallel.wire import Int8Codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    got_p, got_w = collectives.mix_push_sum(
        {n: torch.from_numpy(a) for n, a in params.items()},
        torch.from_numpy(weight), phase,
        build_schedule(NPeerDynamicDirectedExponentialGraph(
            dp, peers_per_itr=1)), StackedTransport(dp),
        codec=Int8Codec(block),
        layout=tlm.reference_layout(tlm.make_model(cfg)))
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))
    for n in params:
        assert np.array_equal(got_p[n].numpy(), np.asarray(want_p[n])), n
        # a shard's slice alone is blocked as the reference's shard is
        assert (params[n][0].size // (ep if is_expert(n) else 1)) % block \
            == 0


def test_int8_wire_refuses_a_slice_that_cuts_a_block():
    shapes = tlm.logical_shapes(drive.config(2))
    check_ep_wire_blocks(shapes, 2, 64)
    with pytest.raises(ValueError, match=r"block_1\.moe\.experts_up's "
                                         r"shard has 4096 elements"):
        check_ep_wire_blocks(shapes, 2, 1000)
    alg = drive.algorithm("sgp", 2, StackedTransport(2))
    from stochastic_gradient_push_torch.parallel.wire import Int8Codec

    alg.wire = Int8Codec(1000)
    with pytest.raises(ValueError, match="--wire_block 1000"):
        tlm.build_lm_train_step(tlm.make_model(drive.config(2)), alg, sgd(),
                                lambda *a: 0.1, 1, ep=StackedEp(2))


def test_expert_slices_round_trip():
    rng = np.random.default_rng(0)
    logical = {n: torch.from_numpy(rng.normal(size=(3, *s)).astype(
        np.float32)) for n, s in tlm.logical_shapes(drive.config(4)).items()}
    parts = [shard_experts(logical, 4, (i,)) for i in range(4)]
    for n, p in parts[1].items():
        if is_expert(n):
            assert p.shape[1] * 4 == logical[n].shape[1]
            assert torch.equal(p, logical[n][:, 2:4])
        else:
            assert p is logical[n]
    back = gather_experts(parts)
    assert all(torch.equal(back[n], logical[n]) for n in logical)


# -- the command line --------------------------------------------------------

SMALL = ["--device", "cpu", "--vocab_size", "64", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "4", "--d_ff", "32",
         "--seq_len", "32", "--batch_size", "2", "--print_freq", "1",
         "--corpus_tokens", "4000", "--moe_experts", "8"]


def _rows(out: str) -> list:
    return [ln.split(",")[:4] + ln.split(",")[5:]
            for ln in out.splitlines() if ln.split(",")[0].isdigit()]


@pytest.mark.parametrize("mesh,log", [
    (["--world_size", "4", "--ep", "2"], "world 4 = dp 2 x ep 2 (2 in"),
    (["--world_size", "8", "--ep", "2", "--sp", "2", "--attn", "ring_flash",
      "--remat", "True"], "world 8 = dp 2 x ep 2 x sp 2 (2 in"),
    (["--world_size", "2", "--sp", "2", "--attn", "ring"],
     "world 2 = dp 1 x sp 2 (1 in"),
    (["--world_size", "2", "--precision", "bf16"], "world 2 (2 in"),
])
def test_cli_trains_moe(tmp_path, capsys, mesh, log):
    result = gossip_lm.main(SMALL + mesh + ["--num_steps", "2",
                                            "--checkpoint_dir",
                                            str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(result["final_loss"])
    assert log in out and "moe 8 experts every 2 blocks" in out
    assert "step,loss,ppl,lr,tokens_per_sec,grad_norm,moe_dropped" in out
    rows = _rows(out)
    assert len(rows) == 2 and all(0 <= float(r[-1]) <= 1 for r in rows)
    csv = (tmp_path / f"lm_out_n{mesh[1]}.csv").read_text().splitlines()
    assert csv[0].endswith(",moe_dropped") and len(csv) == 3


def test_cli_resume_equals_continue(tmp_path, capsys):
    """``--ep 2`` stacked: 4 steps straight equal 2 steps, then a resume
    to 4 (rows outside tokens/s, and the files); the files hold the
    logical leaves (every expert)."""
    argv = SMALL + ["--world_size", "4", "--ep", "2"]

    def files(ckpt):
        return [torch.load(ckpt / f"lm_checkpoint_r{r}_n4.ckpt",
                           weights_only=True)["state"] for r in range(2)]

    straight, split = tmp_path / "straight", tmp_path / "split"
    gossip_lm.main(argv + ["--num_steps", "4", "--checkpoint_dir",
                           str(straight)])
    rows = _rows(capsys.readouterr().out)
    gossip_lm.main(argv + ["--num_steps", "2", "--checkpoint_dir",
                           str(split)])
    first = _rows(capsys.readouterr().out)
    for f in files(split):
        assert {n: tuple(t.shape) for n, t in f["params"].items()} == (
            tlm.logical_shapes(drive.config(2)))
    gossip_lm.main(argv + ["--num_steps", "4", "--resume", "True",
                           "--checkpoint_dir", str(split)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert len(rows) == 4 and first + _rows(out) == rows
    for a, b in zip(files(straight), files(split)):
        for part in ("params", "opt_state"):
            assert all(torch.equal(a[part][n], b[part][n])
                       for n in a[part]), part


@pytest.mark.parametrize("argv,match", [
    (["--moe_experts", "0", "--ep", "2", "--world_size", "2"],
     r"--ep requires --moe_experts > 0"),
    (["--ep", "3", "--world_size", "3"], "moe_experts 8 not divisible by ep 3"),
    (["--ep", "2", "--sp", "2", "--world_size", "6", "--attn", "ring"],
     r"world_size 6 not divisible by sp\*tp\*ep\*pp 4"),
    (["--ep", "2", "--world_size", "2", "--attn", "ring"],
     r"--ep with ring attention needs --sp > 1 \(the 3-D gossip × ep × seq "
     r"mesh\)"),
    (["--ep", "2", "--world_size", "2", "--health_every", "1"],
     r"--health_every composes with the flat dp and dp×sp meshes only "
     r"\(not ep/tp/pp\)"),
    (["--moe_every", "0"], "moe_every must be >= 1 when moe_experts > 0"),
    (["--ep", "0"], "--sp, --tp, --ep and --pp must be >= 1"),
    (["--tp", "2", "--world_size", "2", "--attn", "ring"],
     r"--tp with ring attention requires --sp > 1 \(3-D mesh\)"),
    (["--ep", "2", "--world_size", "4", "--wire_dtype", "int8",
      "--wire_block", "1000"],
     r"block_1\.moe\.experts_up's shard has 4096 elements, not a multiple "
     r"of --wire_block 1000"),
])
def test_cli_refusals_keep_the_reference_messages(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + ["--num_steps", "1", "--checkpoint_dir",
                                str(tmp_path)] + argv)


def test_ep_with_sp_across_processes_is_refused_by_name():
    """The (gossip, ep, seq) mesh resolves for 8 processes as for 8
    stacked ranks (``tests/test_torch_ep_tp_dist.py`` runs it); what the
    reference refuses on it stays refused by name: ``--health_every``
    and an ep shard count that does not divide the experts."""
    args = gossip_lm.build_parser().parse_args(
        SMALL + ["--ep", "2", "--sp", "2", "--attn", "ring"])
    assert gossip_lm.resolve_seq_flags(args, 8) == (2, "ring")
    args.health_every = 1
    with pytest.raises(SystemExit, match=r"--health_every composes with "
                                         r"the flat dp and dp×sp meshes "
                                         r"only \(not ep/tp/pp\)"):
        gossip_lm.resolve_seq_flags(args, 8)
    args.health_every, args.ep = 0, 3
    with pytest.raises(SystemExit, match="moe_experts 8 not divisible by "
                                         "ep 3"):
        gossip_lm.resolve_seq_flags(args, 12)


def test_cli_refuses_cross_world_resume_at_ep(tmp_path):
    (tmp_path / "lm_checkpoint_r0_n2.ckpt").write_bytes(b"")
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .*world \[2\].*--ep 2 > 1"):
        gossip_lm.main(SMALL + ["--world_size", "4", "--ep", "2",
                                "--num_steps", "2", "--resume", "True",
                                "--checkpoint_dir", str(tmp_path)])
