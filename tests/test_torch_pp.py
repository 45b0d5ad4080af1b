"""Pipeline parallelism on the stacked lane (``parallel/pipeline.py::
StackedPipe``, a replica's ``pp`` stages in one process), held against
the reference's compiled ``build_pp_train_step`` and
``build_pp_eval_step`` on its CPU meshes, weights carried across by
``train_state_from_jax``, at ``tests/test_pipeline.py``'s sizes (d32,
h4, ff64, vocab 64, T16; two microbatches of two sequences).

* **Two steps against the reference** on ``make_dp_pp_mesh(2, 2)``
  (dense at L4, SGP; MoE at ep 1, L2),
  ``make_dp_pp_sp_mesh(2, 2, 2)`` (ring attention, L4),
  ``make_dp_pp_ep_mesh(2, 2, 2)`` (MoE, L2) and
  ``make_dp_pp_ep_sp_mesh(1, 2, 2, 2)`` (AllReduce): loss and ``ppl``
  1e-5 relative, ``grad_norm`` 1e-4 relative (the reference's mean over
  stages of each stage's norm), params atol 2e-6, momentum atol 4e-6,
  the push-sum weight and ``moe_dropped`` exactly (the routing drops
  tokens: capacity 1.25 a microbatch); the eval step 1e-5 on the first
  and the last mesh.
* **The int8 round** on the stacked stage leaves equals the reference's
  compiled round on ``make_dp_pp_mesh(2, 2)``, where each stage encodes
  its own ``[L/pp, ...]`` leaves, bit for bit, at a width where a block
  spans the stage's two layers; a stage leaf that a block would cut is
  refused naming the leaf.
* **The converters and the layout**: the pipeline tree in and out,
  :func:`assemble` against the stage leaves, ``reference_layout``'s
  order against JAX's flatten order of the reference's tree, and the
  process grid against the reference's ``(gossip, pipe, ep, seq)``
  device order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models.convert import (
    assemble, flatten_tree, init_params, params_from_jax, params_to_jax,
    pipeline_tree, reference_layout, unflatten_tree)
from stochastic_gradient_push_torch.models.pipeline import PipelineStageLM
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import StackedEp
from stochastic_gradient_push_torch.parallel.mesh import make_dp_sp_layout
from stochastic_gradient_push_torch.parallel.pipeline import StackedPipe
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.wire import Int8Codec
from stochastic_gradient_push_torch.train import pp as tpp
import torch_pp_drive as drive

LOSS_RTOL, GN_RTOL, PARAM_ATOL, MOM_ATOL = 1e-5, 1e-4, 2e-6, 4e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(got: dict, part: str, pp: int) -> dict:
    """A run's final ``part`` (params or momentum) as the reference's
    flattened pipeline tree."""
    return flatten_tree(params_to_jax(
        {k.split("/", 1)[1]: v for k, v in got.items()
         if k.startswith(part + "/")}, pp=pp))


@pytest.mark.parametrize("dp,pp,ep,sp,n_layers,moe,name,ev", [
    (2, 2, 1, 1, 4, False, "sgp", True),        # (gossip, pipe)
    (2, 2, 1, 1, 2, True, "sgp", False),        # MoE at ep 1
    (2, 2, 1, 2, 4, False, "sgp", False),       # (gossip, pipe, seq), ring
    (2, 2, 2, 1, 2, True, "sgp", False),        # (gossip, pipe, ep)
    (1, 2, 2, 2, 2, True, "allreduce", True),   # (gossip, pipe, ep, seq)
])
def test_steps_match_the_reference(dp, pp, ep, sp, n_layers, moe, name,
                                   ev):
    data = drive.batches(dp, ep, sp, 3)
    start, end, want, want_eval = drive.jax_run(dp, pp, ep, sp, data,
                                                n_layers, moe, name,
                                                with_eval=ev)
    got = drive.run(name, dp, StackedTransport(dp), StackedPipe(pp), data,
                    n_layers, sp, StackedSeq(sp) if sp > 1 else None,
                    StackedEp(ep) if ep > 1 else None, moe,
                    start=drive.stacked_start(start, pp))
    for i, m in enumerate(want):
        for k, rtol in (("loss", LOSS_RTOL), ("ppl", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(got[f"{k}/{i}"], np.asarray(m[k]),
                                       rtol=rtol, atol=0, err_msg=k)
        if moe:
            assert np.array_equal(got[f"moe_dropped/{i}"],
                                  np.asarray(m["moe_dropped"]))
    if moe:
        # the routing dropped tokens: each microbatch's capacity is real
        assert float(got["moe_dropped/0"].max()) > 0
    if ev:
        np.testing.assert_allclose(got["eval_loss"],
                                   np.asarray(want_eval["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
    ref_p = flatten_tree(end.params)
    ref_m = flatten_tree(next(s.trace for s in end.opt_state
                              if hasattr(s, "trace")))
    for part, ref, atol in (("params", ref_p, PARAM_ATOL),
                            ("momentum", ref_m, MOM_ATOL)):
        mine = _leaves(got, part, pp)
        assert set(mine) == set(ref)
        for k, w in ref.items():
            np.testing.assert_allclose(mine[k], np.asarray(w), rtol=0,
                                       atol=atol, err_msg=f"{part} {k}")
    assert np.array_equal(got["ps_weight"],
                          np.asarray(end.gossip.ps_weight).reshape(-1))


@pytest.mark.parametrize("phase", [0, 1])
def test_int8_round_on_stage_leaves_is_the_references(phase):
    """The stacked stage leaves ``[dp, pp, L/pp, ...]`` mixed on the int8
    wire equal the reference's compiled round on its ``(gossip, pipe)``
    mesh, each stage encoding its ``[L/pp, ...]`` leaves, bit for bit
    (stage and replicated leaves, and the push-sum weight)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.parallel.wire import (
        get_codec as jcodec)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train.pp import (
        PIPE_AXIS, make_dp_pp_mesh)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    dp, pp, block = 2, 2, 64
    cfg = drive.config(4)
    rng = np.random.default_rng(9)
    # the reference's rank-stacked pipeline tree, [dp, L, ...] stacks
    jtree = unflatten_tree({
        k: rng.normal(size=(dp, *np.shape(a))).astype(np.float32)
        for k, a in flatten_tree(pipeline_tree(init_params(cfg, 0))).items()})
    specs = jax.tree_util.tree_map_with_path(
        lambda path, _: P(GOSSIP_AXIS, PIPE_AXIS)
        if any(getattr(p, "key", None) == "stack" for p in path)
        else P(GOSSIP_AXIS), jtree)
    weight = (1.0 + rng.random(dp)).astype(np.float32)
    jsched = jbuild(JGraph(dp, peers_per_itr=1))

    def body(p, w):
        return mix_push_sum(p, w, jax.numpy.int32(phase), jsched,
                            GOSSIP_AXIS, codec=jcodec("int8", block))

    want_p, want_w = jax.jit(jax.shard_map(
        body, mesh=make_dp_pp_mesh(dp, pp), in_specs=(specs, P(GOSSIP_AXIS)),
        out_specs=(specs, P(GOSSIP_AXIS))))(jtree, weight)
    params = params_from_jax(jtree, pp=pp)
    got_p, got_w = collectives.mix_push_sum(
        params, torch.from_numpy(weight), phase,
        build_schedule(NPeerDynamicDirectedExponentialGraph(
            dp, peers_per_itr=1)), StackedTransport(dp),
        codec=Int8Codec(block),
        layout=reference_layout(tpp.make_pp_model(cfg, pp)))
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))
    got = flatten_tree(params_to_jax(got_p, pp=pp))
    want = flatten_tree(jax.device_get(want_p))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # a stage's ln scale [2, 32] is one block spanning its two layers
    assert params["stack.ln1.weight"][0, 0].numel() == block


def test_int8_wire_refuses_a_stage_leaf_that_cuts_a_block():
    # at one layer a stage a LayerNorm scale is 32 elements: two stacked
    # stages would share a block
    model = tpp.make_pp_model(drive.config(2), 2)
    with pytest.raises(ValueError, match=r"stack\.ln1\.weight's stage "
                                         r"holds 32 elements"):
        tpp.check_pp_wire_blocks(model, 2, 1, 64)
    # one stage a process blocks it alone, as the reference does
    tpp.check_pp_wire_blocks(model, 1, 1, 64)
    moe = tpp.make_pp_model(drive.config(4, ep=2, moe=True), 2)
    with pytest.raises(ValueError, match="ep slices interleave"):
        tpp.check_pp_wire_blocks(moe, 2, 2, 64)
    alg = drive.algorithm("sgp_int8", 2, StackedTransport(2))
    with pytest.raises(ValueError, match="--wire_block 64"):
        tpp.build_pp_train_step(model, alg, drive.sgd(), lambda *a: 0.1, 1,
                                pipe=StackedPipe(2), n_micro=2)


def test_converters_round_trip_and_assemble():
    cfg = drive.config(4, moe=True)
    rng = np.random.default_rng(1)
    # a rank-stacked TransformerLM tree, [R, ...] leaves
    stacked = {k: rng.normal(size=(2, *np.shape(v))).astype(np.float32)
               for k, v in flatten_tree(init_params(cfg, 0)).items()}
    tree = pipeline_tree(unflatten_tree(stacked))
    assert np.shape(tree["stack"]["block"]["attn"]["q"]["kernel"]) == (
        2, 4, 32, 32)
    assert np.shape(tree["stack"]["block"]["moe"]["experts_up"]) == (
        2, 4, 4, 32, 64)
    for pp in (1, 2, 4):
        port = params_from_jax(tree, pp=pp)
        assert port["stack.attn.q.weight"].shape == (2, pp, 4 // pp, 32, 32)
        assert port["embed.weight"].shape == (2, 64, 32)
        back = flatten_tree(params_to_jax(port, pp=pp))
        want = flatten_tree(tree)
        assert set(back) == set(want)
        assert all(np.array_equal(back[k], want[k]) for k in want)
        # stage s holds layers [s·L/pp, (s+1)·L/pp)
        q = port["stack.attn.q.weight"]
        for s_ in range(pp):
            for i in range(4 // pp):
                assert np.array_equal(
                    q[:, s_, i].numpy(), np.swapaxes(
                        tree["stack"]["block"]["attn"]["q"]["kernel"][
                            :, s_ * (4 // pp) + i], -1, -2))
    full = assemble(tree)
    for i in range(4):
        for k, v in flatten_tree(full[f"block_{i}"]).items():
            assert np.array_equal(v, stacked[f"block_{i}/{k}"]), (i, k)
    assert all(np.array_equal(flatten_tree(pipeline_tree(full))[k],
                              flatten_tree(tree)[k])
               for k in flatten_tree(tree))


@pytest.mark.parametrize("moe", [False, True])
def test_reference_layout_is_the_pipeline_trees_order(moe):
    import jax

    from stochastic_gradient_push_tpu.models import (
        PipelineStageLM as JStage)
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig)

    cfg = drive.config(4, moe=moe)
    jm = JStage(JConfig(vocab_size=drive.VOCAB, d_model=drive.D,
                        n_layers=4, n_heads=drive.H, d_ff=drive.FF,
                        max_len=drive.T, moe_experts=cfg.moe_experts,
                        moe_every=1), n_local_layers=2)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0),
        jax.numpy.zeros((2, 2, drive.T), jax.numpy.int32)))["params"]
    paths = ["/".join(str(p.key) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = tpp.make_pp_model(cfg, 2)
    layout = reference_layout(model)
    to_path = {n: (("stack/block/" + n[6:]) if n.startswith("stack.")
                   else n).replace(".", "/") for n in layout.order}
    got = [to_path[n].replace("/weight", "/kernel") for n in layout.order]
    want = []
    for p in paths:
        want.append(p.replace("/embedding", "/kernel").replace(
            "/scale", "/kernel"))
    assert got == want
    assert layout.perm("stack.attn.q.weight") == (0, 1, 3, 2)
    assert layout.perm("lm_head.weight") == (1, 0)
    assert layout.perm("stack.ln1.weight") is None
    # every stage leaf is [L/pp, ...] in the module, [held, L/pp, ...] held
    assert dict(model.named_parameters())["stack.attn.q.weight"].shape == (
        2, 32, 32)


def test_moe_needs_an_expert_block_every_layer():
    with pytest.raises(ValueError, match="moe_every=1"):
        PipelineStageLM(dataclasses.replace(drive.config(2, moe=True),
                                            moe_every=2), 1)


def test_process_grid_is_the_references_device_order():
    from stochastic_gradient_push_tpu.train.pp import (
        make_dp_pp_ep_sp_mesh, make_dp_pp_mesh)

    for dp, pp, ep, sp in ((2, 2, 1, 1), (1, 2, 2, 2)):
        mesh = (make_dp_pp_mesh(dp, pp) if ep == sp == 1
                else make_dp_pp_ep_sp_mesh(dp, pp, ep, sp))
        ids = np.vectorize(lambda d: d.id)(mesh.devices).reshape(
            dp, pp, ep, sp)
        layout = make_dp_sp_layout(dp * pp * ep * sp, sp, 1, ep, pp)
        assert layout.dp == dp
        for r, s, e, i in np.ndindex(dp, pp, ep, sp):
            p = layout.proc(r, i, 0, e, s)
            assert p == ids[r, s, e, i]
            assert layout.grid(p) == (r, e, i, 0) and layout.stage(p) == s
        assert layout.pp_members(0) == [layout.proc(0, 0, 0, 0, s)
                                        for s in range(pp)]
        assert len(layout.all_dp_members()) == pp * ep * sp
    # the divisibility message prints the product with pp
    with pytest.raises(ValueError, match=r"world_size 6 not divisible by "
                                         r"sp\*tp\*ep\*pp 4"):
        make_dp_sp_layout(6, 2, 1, 1, 2)
    with pytest.raises(ValueError, match=r"sp\*tp\*ep\*pp 3"):
        make_dp_sp_layout(8, 1, 1, 1, 3)
    with pytest.raises(ValueError, match="pp must be >= 1"):
        make_dp_sp_layout(8, 1, 1, 1, 0)


@pytest.mark.parametrize("dp,ep,sp", [(1, 1, 2), (1, 2, 1), (1, 2, 2),
                                      (2, 2, 1)])
def test_every_process_makes_the_groups_in_one_order(monkeypatch, dp, ep,
                                                     sp):
    """``new_group`` is collective over the world: on the pipeline meshes
    every process makes the sp, dp, ep and pipe groups in one order, and
    is handed the four that hold it, whole."""
    import torch.distributed as dist

    from stochastic_gradient_push_torch.parallel.mesh import join_groups

    made = []
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(
        list(ranks)) or tuple(ranks))
    pp = 2
    layout = make_dp_sp_layout(dp * pp * ep * sp, sp, 1, ep, pp)
    orders = []
    for p in range(layout.world):
        made.clear()
        groups = join_groups(layout, p)
        orders.append(list(made))
        replica, e, shard, t = layout.grid(p)
        s = layout.stage(p)
        assert groups.tp is None
        assert groups.sp == tuple(layout.sp_members(replica, t, e, s))
        assert groups.dp == tuple(layout.dp_members(shard, t, e, s))
        assert groups.ep == (tuple(layout.ep_members(replica, shard, t, s))
                             if ep > 1 else None)
        assert groups.pp == tuple(layout.pp_members(replica, e, shard, t))
        assert all(p in g for g in groups if g is not None)
    assert all(o == orders[0] for o in orders)
    # sp groups, then dp, then ep, then pipe; each process in one of each
    n = dp * pp * ep * sp
    kinds = [n // sp, n // dp] + ([n // ep] if ep > 1 else []) + [n // pp]
    assert len(orders[0]) == sum(kinds)
    assert sorted(map(tuple, orders[0][-n // pp:])) == sorted(
        tuple(layout.pp_members(r, e_, i)) for r in range(dp)
        for e_ in range(ep) for i in range(sp))


def test_converters_place_one_process_block():
    """``params_from_jax`` with ``pp``, ``stages``, ``ep`` and ``ep_shards``
    gives a process its ``(stage, e)`` block (``[R, 1, L/pp, E/ep, ...]``
    of an expert stack, ``[R, 1, L/pp, ...]`` of the router, replicated
    leaves whole); ``join_stages`` and ``params_to_jax`` of every
    process's block give back the reference's logical tree, and
    ``train_state_from_jax`` places the same block."""
    import types

    from stochastic_gradient_push_torch.models.convert import (
        join_stages, train_state_from_jax)

    cfg = drive.config(4, moe=True)
    rng = np.random.default_rng(2)
    tree = pipeline_tree(unflatten_tree({
        k: rng.normal(size=(2, *np.shape(v))).astype(np.float32)
        for k, v in flatten_tree(init_params(cfg, 0)).items()}))
    pp, ep = 2, 2
    full = params_from_jax(tree, pp=pp)
    blocks = {}
    for s, e in np.ndindex(pp, ep):
        got = params_from_jax(tree, ep=ep, ep_shards=[e], pp=pp, stages=[s])
        assert got["stack.moe.experts_up"].shape == (2, 1, 2, 2, 32, 64)
        assert got["stack.moe.router"].shape == (2, 1, 2, 32, 4)
        assert got["embed.weight"].shape == (2, 64, 32)
        for n, t in got.items():
            want = full[n]
            if n.startswith("stack."):
                want = want[:, s:s + 1]
                if n.endswith(("experts_up", "experts_down")):
                    want = want.chunk(ep, -3)[e]
            assert torch.equal(t, want), n
        blocks[s, e] = got
    back = flatten_tree(params_to_jax(
        [join_stages([blocks[s, e] for s in range(pp)]) for e in range(ep)],
        ep=ep, pp=pp))
    want = flatten_tree(tree)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    # a whole rank-stacked state: params and momentum placed alike
    state = types.SimpleNamespace(
        params=tree, step=np.zeros(2, np.int32),
        opt_state=(types.SimpleNamespace(trace=tree),),
        gossip=types.SimpleNamespace(phase=np.zeros(2, np.int32),
                                     ps_weight=np.ones(2, np.float32)))
    got = train_state_from_jax(state, pp=pp, stages=[1], ep=ep,
                               ep_shards=[0])
    for part in (got.params, got.opt_state):
        for n, t in part.items():
            assert torch.equal(t, blocks[1, 0][n]), n


def test_int8_wire_sees_the_process_block():
    """One stage and one ep slice a process hold the reference's own
    int8 block unit, ``[L/pp, E/ep, ...]``: nothing to refuse where the
    stacked stages' interleaved slices are refused."""
    moe = tpp.make_pp_model(drive.config(4, ep=2, moe=True), 2)
    with pytest.raises(ValueError, match="ep slices interleave"):
        tpp.check_pp_wire_blocks(moe, 1, 2, 64)
    tpp.check_pp_wire_blocks(moe, 1, 2, 64, held_ep=1)
    # stacked stages of one ep slice: the slice's size decides
    with pytest.raises(ValueError, match=r"stack\.ln1\.weight's stage "
                                         r"holds 64 elements, not a "
                                         r"multiple of --wire_block 48"):
        tpp.check_pp_wire_blocks(moe, 2, 2, 48, held_ep=1)
