"""MoE under tensor parallelism on the stacked lane (``parallel/tp.py::
StackedTp`` beside ``parallel/ep.py::StackedEp``, a replica's shards in
one process), held against the reference's ``build_lm_train_step`` on
its CPU meshes with the auto ``tp`` axis (``make_dp_ep_tp_mesh``,
``make_dp_ep_sp_tp_mesh``, ``make_dp_tp_mesh``, ``make_dp_sp_tp_mesh``),
weights carried across by ``train_state_from_jax``, at
``tests/test_expert_parallel_lm.py``'s tp sizes (d32, L2, h4, F64, V64,
4 experts on block 1, T32, B2).

* **Placement**: ``split_dim`` and ``is_expert`` put tp on the F dim of
  each expert stack and ep on its expert dim where the reference's
  ``ep_tp_sharding_tree`` does (and ``tp_sharding_tree`` at ep 1); the
  router is replicated.
* **Two steps against the reference** at dp 2 x ep 2 x tp 2, dp 1 x ep
  2 x sp 2 x tp 2 and MoE at ep 1 (dp 2 x tp 2, and dp 2 x sp 2 x tp 2
  with per-block routing), SGP: losses and ``ppl`` 1e-5 relative,
  ``moe_dropped`` exactly, grad norms 1e-4 relative, params atol 2e-6,
  momentum ``MOM_ATOL`` (4e-6), the push-sum weight exactly (the
  tolerances of ``tests/test_torch_ep_lm.py``: the frameworks differ in
  the order of fp32 sums only).  The first step's routing is the
  reference's by a margin: the smallest top-1 / top-2 router probability
  gap of the seeded inputs is asserted above 1e-6, ten times the 1e-7
  the two frameworks' router probabilities are held to
  (``tests/test_torch_moe.py``; these inputs' gaps are 6.8e-6 to
  1.8e-4).
* **Against the port's ep only** (SGP, OSGP, AllReduce; sp 1 and 2): the
  tp split reorders fp32 sums only, so losses, grad norms and the eval
  loss within the reference test's rtol 2e-5 / atol 2e-5, the dropped
  fraction and the push-sum weight exactly, gathered params and momentum
  atol 2e-6.
* **remat** at tp 2 recomputes each block with the first pass's tp sums
  read back (the MoE's fold among them): bit-equal to no remat, the same
  count of sums.
* **The int8 wire**: a round on the ``(e, t)`` expert shards equals the
  reference's compiled round on ``make_dp_ep_tp_mesh``, where each ep
  shard blocks its slice at full F, bit for bit; a shard whose ``F / tp``
  cuts a block is refused naming the leaf.
* **Converters**: ``params_from_jax(tree, tp, ep)`` and
  ``params_to_jax(parts, tp, ep)`` round-trip a MoE tree at tp 2, ep 2
  exactly; one ``(e, t)`` shard is the logical leaf's slice.
* **The command line**: MoE trains under ``--tp 2`` on the four stacked
  meshes, with the ``moe_dropped`` column; a stacked resume equals the
  run that never stopped, and the files hold the logical leaves.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models.convert import (
    flatten_tree, init_params, params_from_jax, params_to_jax,
    train_state_from_jax, unflatten_tree)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig, TransformerLM)
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.ep import StackedEp, is_expert
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import (
    StackedTp, check_wire_blocks, gather_params, shard_params, split_dim)
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.state import sgd
import torch_ep_drive as drive
import torch_lm_drive as lm_drive

E, FF = 4, 64
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
# the reference's test_moe_ep_with_tp_matches_ep_only
EP_ONLY_RTOL = EP_ONLY_ATOL = 2e-5
MARGIN = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _config(ep=1, tp=1, impl="full", **kw):
    return drive.config(ep, impl, experts=E, tp=tp, ff=FF, **kw)


# -- placement ------------------------------------------------------------


def _port_name(keys) -> str:
    leaf = keys[-1]
    if leaf in ("router", "experts_up", "experts_down"):
        return ".".join(keys)
    return ".".join(keys[:-1] + [{"embedding": "weight", "kernel": "weight",
                                  "scale": "weight", "bias": "bias"}[leaf]])


@pytest.mark.parametrize("ep", [1, 2])
def test_placement_matches_the_reference_trees(ep):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.train.lm import (
        EP_AXIS, TP_AXIS, ep_tp_sharding_tree, make_dp_ep_tp_mesh,
        make_dp_tp_mesh, tp_sharding_tree)

    model = JLM(JConfig(vocab_size=drive.VOCAB, d_model=drive.D,
                        n_layers=drive.L, n_heads=drive.H, d_ff=FF,
                        max_len=drive.T, attn_impl="full", moe_experts=E,
                        moe_every=2))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((drive.B, drive.T),
                                         jnp.int32)))["params"]
    stacked = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct((2,) + a.shape, a.dtype), shapes)
    specs = (ep_tp_sharding_tree(stacked, make_dp_ep_tp_mesh(2, 2, 2))
             if ep > 1 else tp_sharding_tree(stacked, make_dp_tp_mesh(2, 2)))
    seen = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [p.key for p in path]
        name = _port_name(keys)
        ndim = len(_leaf(shapes, keys).shape)
        tail = (list(sharding.spec)[1:] + [None] * ndim)[:ndim]
        assert (EP_AXIS in tail) == (ep > 1 and is_expert(name)), name
        if EP_AXIS in tail:
            assert tail.index(EP_AXIS) == 0, name
        if TP_AXIS not in tail:
            want = 0 if name.endswith("up.bias") else None
        elif name.rpartition(".")[2] in ("experts_up", "experts_down"):
            want = tail.index(TP_AXIS)         # raw leaves: no transpose
        else:
            want = ndim - 1 - tail.index(TP_AXIS)    # [in, out] -> [out, in]
        assert split_dim(name) == want, (name, tail)
        seen[name] = want
    # the expert stacks split on F, the router replicated
    assert seen["block_1.moe.experts_up"] == 2
    assert seen["block_1.moe.experts_down"] == 1
    assert seen["block_1.moe.router"] is None


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# -- against the reference ------------------------------------------------


def _margin(start, data, dp, ep, sp) -> float:
    """The smallest top-1 / top-2 router probability gap over the first
    batch's tokens at the start parameters (the port's tp 1 model on
    each replica and ep shard's whole sequences: a token's probabilities
    do not depend on how its sequence is cut)."""
    cfg = _config()
    model = TransformerLM(cfg)
    got = []
    model.block_1.moe.register_forward_hook(
        lambda mod, args, out: got.append(args[0]))
    toks = data[0][0].reshape(dp, ep, sp, drive.B, -1)
    gaps = []
    for r in range(dp):
        model.load_state_dict({n: p[r] for n, p in start.params.items()})
        for e in range(ep):
            x = np.concatenate(list(toks[r, e]), axis=-1)
            got.clear()
            with torch.no_grad():
                model(torch.from_numpy(x).long())
                h = got[0]
                probs = torch.softmax(h @ model.block_1.moe.router, -1)
            top = probs.topk(2, -1).values
            gaps.append(float((top[..., 0] - top[..., 1]).min()))
    return min(gaps)


@pytest.fixture(scope="module")
def reference():
    torch.set_num_threads(1)
    out = {}
    for dp, ep, sp in ((2, 2, 1), (1, 2, 2), (2, 1, 1), (2, 1, 2)):
        data = drive.batches(dp, ep, sp, 11, steps=2)
        out[dp, ep, sp] = data, drive.jax_run(dp, ep, sp, data, tp=2,
                                              experts=E, ff=FF)
    return out


@pytest.mark.parametrize("dp,ep,sp", [
    (2, 2, 1),      # (gossip, ep, tp)
    (1, 2, 2),      # (gossip, ep, seq, tp), ring
    (2, 1, 1),      # MoE at ep 1 on (gossip, tp)
    (2, 1, 2),      # MoE at ep 1 on (gossip, seq, tp): per-block routing
])
def test_steps_match_the_reference(reference, dp, ep, sp):
    data, (start, end, want) = reference[dp, ep, sp]
    begin = train_state_from_jax(start)
    assert _margin(begin, data, dp, ep, sp) > MARGIN
    got = drive.run("sgp", dp, StackedTransport(dp),
                    StackedEp(ep) if ep > 1 else None, data, sp=sp,
                    seq=StackedSeq(sp) if sp > 1 else None,
                    impl="ring" if sp > 1 else "full", tp=StackedTp(2),
                    experts=E, ff=FF, start=begin)
    # the routing dropped tokens: the capacity is really exercised
    assert float(got["moe_dropped/0"].max()) > 0
    for i, m in enumerate(want):
        for k, rtol in (("loss", LOSS_RTOL), ("ppl", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(got[f"{k}/{i}"],
                                       np.asarray(m[k]).reshape(-1),
                                       rtol=rtol, atol=0, err_msg=k)
        assert np.array_equal(got[f"moe_dropped/{i}"],
                              np.asarray(m["moe_dropped"]).reshape(-1))
    ref = train_state_from_jax(end)
    params, momentum = (gather_params({
        k.split("/", 1)[1]: torch.from_numpy(v) for k, v in got.items()
        if k.startswith(part + "/")}, 2) for part in ("params", "momentum"))
    for n, w in ref.params.items():
        np.testing.assert_allclose(params[n].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        np.testing.assert_allclose(momentum[n].numpy(),
                                   ref.opt_state[n].numpy(), rtol=0,
                                   atol=lm_drive.MOM_ATOL, err_msg=n)
    assert np.array_equal(got["ps_weight"], ref.gossip.ps_weight.numpy())


# -- against the port's ep only -----------------------------------------


def _logical(out: dict, part: str, tp: int) -> dict:
    tree = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(part + "/")}
    return gather_params(tree, tp) if tp > 1 else tree


def _stacked(name, tp, sp, remat=False):
    dp, ep = 2, 2
    return drive.run(name, dp, StackedTransport(dp), StackedEp(ep),
                     drive.batches(dp, ep, sp, 13), sp=sp,
                     seq=StackedSeq(sp) if sp > 1 else None,
                     impl="ring" if sp > 1 else "full", remat=remat,
                     tp=StackedTp(tp) if tp > 1 else None, experts=E, ff=FF)


@pytest.mark.parametrize("name,sp", [("sgp", 1), ("sgp", 2), ("osgp", 1),
                                     ("allreduce", 1)])
def test_ep_tp_equals_ep_only(name, sp):
    """The reference's ``test_moe_ep_with_tp_matches_ep_only`` on the
    port: the same tokens and routing, so the same losses."""
    want, got = _stacked(name, 1, sp), _stacked(name, 2, sp)
    for k in want:
        part = k.split("/")[0]
        if part in ("loss", "ppl", "grad_norm", "eval_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=EP_ONLY_RTOL,
                                       atol=EP_ONLY_ATOL, err_msg=k)
        elif part in ("moe_dropped", "ps_weight"):
            assert np.array_equal(got[k], want[k]), k
    for part in ("params", "momentum"):
        assert lm_drive.tree_err(_logical(got, part, 2),
                                 _logical(want, part, 1)) <= PARAM_ATOL
    assert int(got["reductions"]) > 0 and "reductions" not in want


@pytest.mark.parametrize("sp", [1, 2])
def test_remat_reads_back_the_moe_sums(sp):
    plain, remat = _stacked("sgp", 2, sp), _stacked("sgp", 2, sp, True)
    assert set(plain) == set(remat)
    for k in plain:
        assert np.array_equal(plain[k], remat[k]), k


# -- the int8 wire ----------------------------------------------------------


@pytest.mark.parametrize("phase", [0, 1])
def test_int8_round_on_expert_shards_is_the_references(phase):
    """The stacked lane's int8 round over the ``(e, t)`` expert slices
    ``[dp, tp, E, D, F/tp]`` equals the reference's compiled round on its
    ``(gossip, ep, tp)`` mesh (tp auto: each ep shard encodes its slice
    at full F), bit for bit, expert and replicated leaves and the
    push-sum weight."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.parallel.wire import (
        get_codec as jcodec)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train.lm import (
        EP_AXIS, TP_AXIS, make_dp_ep_tp_mesh)
    from stochastic_gradient_push_torch.parallel.wire import Int8Codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    dp, ep, tp, block = 2, 2, 2, 32
    cfg = _config(ep, tp)
    shapes = {n: s for n, s in tlm.logical_shapes(cfg).items()
              if ".moe." in n}
    check_wire_blocks(shapes, tp, block)
    rng = np.random.default_rng(9)
    params = {n: rng.normal(size=(dp, *s)).astype(np.float32)
              for n, s in shapes.items()}
    weight = (1.0 + rng.random(dp)).astype(np.float32)
    mesh = make_dp_ep_tp_mesh(dp, ep, tp)
    specs = {n: P(GOSSIP_AXIS, EP_AXIS) if is_expert(n) else P(GOSSIP_AXIS)
             for n in params}
    tail = {"experts_up": (None, TP_AXIS), "experts_down": (TP_AXIS, None)}
    placed = {n: jax.device_put(a, NamedSharding(mesh, P(
        GOSSIP_AXIS, EP_AXIS, *tail[n.rpartition(".")[2]])
        if is_expert(n) else P(GOSSIP_AXIS))) for n, a in params.items()}
    jsched = jbuild(JGraph(dp, peers_per_itr=1))

    def body(p, w):
        return mix_push_sum(p, w, jnp.int32(phase), jsched, GOSSIP_AXIS,
                            codec=jcodec("int8", block))

    want_p, want_w = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(specs, P(GOSSIP_AXIS)),
        out_specs=(specs, P(GOSSIP_AXIS)),
        axis_names={GOSSIP_AXIS, EP_AXIS}))(placed, weight)
    got_p, got_w = collectives.mix_push_sum(
        shard_params({n: torch.from_numpy(a) for n, a in params.items()},
                     tp), torch.from_numpy(weight), phase,
        build_schedule(NPeerDynamicDirectedExponentialGraph(
            dp, peers_per_itr=1)), StackedTransport(dp),
        codec=Int8Codec(block),
        layout=tlm.reference_layout(tlm.make_model(cfg)))
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))
    got_p = gather_params(got_p, tp)
    for n in params:
        assert np.array_equal(got_p[n].numpy(), np.asarray(want_p[n])), n


def test_int8_wire_refuses_an_expert_shard_that_cuts_a_block():
    shapes = {n: s for n, s in tlm.logical_shapes(_config(2, 2)).items()
              if ".moe." in n}
    check_wire_blocks(shapes, 2, 32)
    with pytest.raises(ValueError, match=r"block_1\.moe\.experts_up's "
                                         r"shard has F / tp = 32, not a "
                                         r"multiple of --wire_block 64"):
        check_wire_blocks(shapes, 2, 64)
    with pytest.raises(ValueError, match=r"block_1\.moe\.experts_down's "
                                         r"shard has \(F / tp\) \* D = 1024"):
        check_wire_blocks({n: s for n, s in shapes.items()
                           if n.endswith("down")}, 2, 2048)
    # through the step: every block of this model is a MoE block, so the
    # expert stack is the first leaf a 32-block cuts (F / tp = 16)
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_layers=1,
                            n_heads=4, d_ff=32, moe_experts=4, moe_every=1,
                            ep=2, tp=2)
    alg = drive.algorithm("sgp", 2, StackedTransport(2))
    from stochastic_gradient_push_torch.parallel.wire import Int8Codec

    alg.wire = Int8Codec(32)
    with pytest.raises(ValueError, match=r"block_0\.moe\.experts_up's "
                                         r"shard has F / tp = 16"):
        tlm.build_lm_train_step(tlm.make_model(cfg), alg, sgd(),
                                lambda *a: 0.1, 1, tp=StackedTp(2),
                                ep=StackedEp(2))


# -- the converters ----------------------------------------------------------


def test_converters_round_trip_at_tp2_ep2():
    tp, ep = 2, 2
    tree = init_params(_config(), 3)
    rows = {k: np.stack([v, v * 2.0, v - 1.0])
            for k, v in flatten_tree(tree).items()}
    stacked = unflatten_tree(rows)
    parts = [params_from_jax(stacked, tp, ep=ep, ep_shards=(i,))
             for i in range(ep)]
    back = params_to_jax(parts, tp, ep)
    flat = flatten_tree(back)
    assert set(flat) == set(rows)
    for k, v in rows.items():
        assert np.array_equal(flat[k], v), k
    # one (e, t) shard: the logical leaf's experts of e at F slice t
    one = params_from_jax(stacked, tp, shards=(1,), ep=ep, ep_shards=(0,))
    up = rows["block_1/moe/experts_up"]
    assert np.array_equal(one["block_1.moe.experts_up"][:, 0].numpy(),
                          up[:, :E // ep, :, FF // tp:])
    down = rows["block_1/moe/experts_down"]
    assert np.array_equal(one["block_1.moe.experts_down"][:, 0].numpy(),
                          down[:, :E // ep, FF // tp:])
    assert np.array_equal(one["block_1.moe.router"].numpy(),
                          rows["block_1/moe/router"])


# -- the command line --------------------------------------------------------

SMALL = ["--device", "cpu", "--vocab_size", "64", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "4", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--print_freq", "1",
         "--corpus_tokens", "4000", "--moe_experts", "4"]


def _rows(out: str) -> list:
    return [ln.split(",")[:4] + ln.split(",")[5:]
            for ln in out.splitlines() if ln.split(",")[0].isdigit()]


@pytest.mark.parametrize("mesh,log", [
    (["--world_size", "4", "--tp", "2"], "world 4 = dp 2 x tp 2 (2 in"),
    (["--world_size", "4", "--tp", "2", "--sp", "2", "--attn", "ring"],
     "world 4 = dp 1 x sp 2 x tp 2 (1 in"),
    (["--world_size", "8", "--ep", "2", "--tp", "2"],
     "world 8 = dp 2 x ep 2 x tp 2 (2 in"),
    (["--world_size", "8", "--ep", "2", "--sp", "2", "--tp", "2", "--attn",
      "ring_flash", "--remat", "True"],
     "world 8 = dp 1 x ep 2 x sp 2 x tp 2 (1 in"),
])
def test_cli_trains_moe_under_tp(tmp_path, capsys, mesh, log):
    result = gossip_lm.main(SMALL + mesh + ["--num_steps", "2",
                                            "--checkpoint_dir",
                                            str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(result["final_loss"])
    assert log in out and "moe 4 experts every 2 blocks" in out
    rows = _rows(out)
    assert len(rows) == 2 and all(0 <= float(r[-1]) <= 1 for r in rows)
    csv = (tmp_path / f"lm_out_n{mesh[1]}.csv").read_text().splitlines()
    assert csv[0].endswith(",grad_norm,moe_dropped") and len(csv) == 3


def test_cli_resume_equals_continue(tmp_path, capsys):
    """``--ep 2 --tp 2`` stacked: 4 steps straight equal 2 steps, then a
    resume to 4 (rows outside tokens/s, and the files); the files hold
    the logical leaves (every expert at full F)."""
    argv = SMALL + ["--world_size", "8", "--ep", "2", "--tp", "2"]

    def files(ckpt):
        return [torch.load(ckpt / f"lm_checkpoint_r{r}_n8.ckpt",
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
            tlm.logical_shapes(_config(2, 2)))
    gossip_lm.main(argv + ["--num_steps", "4", "--resume", "True",
                           "--checkpoint_dir", str(split)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert len(rows) == 4 and first + _rows(out) == rows
    for a, b in zip(files(straight), files(split)):
        for part in ("params", "opt_state"):
            assert all(torch.equal(a[part][n], b[part][n])
                       for n in a[part]), part
