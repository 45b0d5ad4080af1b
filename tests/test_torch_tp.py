"""Tensor parallelism on the stacked lane (``parallel/tp.py::StackedTp``,
a replica's ``tp`` shards in one process), held against the reference
and against the port's own tp = 1.

* **Placement.**  ``split_dim`` splits the leaves the reference's
  ``tp_sharding_tree`` shards, on the same logical dim (the port's
  ``[out, in]`` is the reference's ``[in, out]`` transposed); ``up``'s
  bias goes with its kernel here, where the reference replicates it and
  GSPMD slices it.  ``shard_params``/``gather_params`` round-trip bit for
  bit, and every split leaf is held as ``1/tp`` of its logical leaf.
* **Reference parity.**  Three SGP steps of the port at tp 2 against the
  reference's compiled ``init_lm_state_tp`` + ``shard_lm_train_step(
  tp=True)`` on its 8-device CPU mesh, ``DP 4 x TP 2``, ``attn_impl
  ="full"``; and at ``dp 2 x sp 2 x tp 2`` (ring attention) against
  ``make_dp_sp_tp_mesh``.  The reference's own tp = 2 test
  (``tests/test_tensor_parallel.py:100-104``) holds losses to rtol 2e-4
  and params to rtol 3e-3 / atol 3e-4; the two frameworks differ only in
  the order of fp32 sums, so these hold losses to 1e-5 relative, grad
  norms to 1e-4 relative and params to atol 2e-6 (the port's other LM
  parity tests' tolerances; they sit 2.4e-7 apart), momentum to
  ``MOM_ATOL`` (4e-6: in the embedding rows many tokens hit, the port's
  tp = 1 and tp = 2 runs both sit ~3e-6 from the reference's and from an
  fp64 run of the port's step, the reference 1.5e-6 from that run), with
  the push-sum weight exact.
* **Against the port's tp = 1** (SGP, OSGP, AllReduce; tp 2 and 4): at
  fp32 the sums over shards only reorder fp32 sums: losses 1e-5
  relative, grad norms 1e-4 relative, gathered params and momentum atol
  2e-6, the push-sum weight exact.  At bf16 a row layer's partial
  products round to bf16 before their sum, so the tp run is held as the
  bf16 tests hold bf16 runs (``tests/torch_lm_drive.py``): losses within
  ``BF16_LOSS_RTOL`` (2e-3) relative of the tp = 1 bf16 run, params from
  the tp = 1 fp32 run between half and twice the tp = 1 bf16 run's
  distance, plus 1e-5.
* **remat** recomputes each block with the first pass's sums over the
  shards read back: bit-equal to no remat, the same count of sums.
* **The int8 wire.**  A shard's int8 blocks, in the reference's ``[in,
  out]`` order, are the reference's blocks of the logical leaf, bit for
  bit (codes and scales); a gossip round on the shards equals the round
  on the logical leaves bit for bit.  A shard that would cut a block is
  refused naming the leaf.
* **Checkpoints.**  The command line's per-replica files hold the
  logical leaves: a run resumed at the same ``--tp`` equals one that
  never stopped, and the files load at another ``--tp``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    params_from_jax, params_to_jax, train_state_from_jax)
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.parallel.tp import (
    StackedTp, check_tp_dims, check_wire_blocks, gather_params,
    gather_state, shard_params, shard_state, split_dim)
from stochastic_gradient_push_torch.parallel.wire import Int8Codec
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
import torch_lm_drive as lm_drive
import torch_tp_drive as drive

torch.set_num_threads(1)

VOCAB, D, L, H, FF, T, B = (drive.VOCAB, drive.D, drive.L, drive.H,
                            drive.FF, drive.T, drive.B)
STEPS = 3
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- placement ------------------------------------------------------------


def test_placement_matches_the_reference_tree():
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.train.lm import (
        make_dp_tp_mesh, tp_sharding_tree)

    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                        n_heads=H, d_ff=FF, max_len=T, attn_impl="full"))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((B, T), jnp.int32)))["params"]
    stacked = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct((4,) + a.shape, a.dtype), shapes)
    specs = tp_sharding_tree(stacked, make_dp_tp_mesh(4, 2))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    seen = set()
    for path, sharding in flat:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [{"embedding": "weight",
                                      "kernel": "weight",
                                      "scale": "weight",
                                      "bias": "bias"}[keys[-1]]])
        tail = list(sharding.spec)[1:]
        tail += [None] * (len(shapes_of(shapes, keys)) - len(tail))
        if "tp" not in tail:
            want = 0 if name.endswith("up.bias") else None
        else:
            # the reference's [in, out]: out is the last dim, in the one
            # before; the port's [out, in] has them the other way round
            want = len(tail) - 1 - tail.index("tp")
        assert split_dim(name) == want, (name, tail)
        seen.add(name)
    assert {n for n in seen if split_dim(n) is not None} == {
        f"block_{i}.{m}.{leaf}" for i in range(L)
        for m, leaf in (("attn.q", "weight"), ("attn.k", "weight"),
                        ("attn.v", "weight"), ("attn.o", "weight"),
                        ("up", "weight"), ("up", "bias"),
                        ("down", "weight"))} | {"lm_head.weight"}


def shapes_of(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree.shape


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_round_trip_and_hold_a_tp_th(tp):
    cfg = drive.config(1)
    rng = np.random.default_rng(0)
    logical = {n: torch.from_numpy(rng.normal(size=(3, *p.shape))
                                   .astype(np.float32))
               for n, p in tlm.make_model(cfg).named_parameters()}
    sharded = shard_params(logical, tp)
    for n, p in sharded.items():
        if split_dim(n) is None:
            assert p is logical[n]
            continue
        assert p.shape[:2] == (3, tp)
        assert p[:, 0].numel() * tp == logical[n].numel(), n
    back = gather_params(sharded, tp)
    assert all(torch.equal(back[n], logical[n]) for n in logical)
    # one shard held, as a process of the process lane holds it
    one = shard_params(logical, tp, shards=(tp - 1,))
    for n, p in one.items():
        if split_dim(n) is not None:
            assert torch.equal(p[:, 0], sharded[n][:, tp - 1])
            assert p.numel() * tp == logical[n].numel()
    # the meta model's shapes are the stacked shards'
    model = tlm.make_model(drive.config(tp))
    assert {n: tuple(p.shape[1:]) for n, p in sharded.items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="holds 1 of"):
        gather_params(one, tp)


@pytest.mark.parametrize("dims,match", [
    ((30, 64, 64), "d_model 30 not divisible by tp 4"),
    ((32, 66, 64), "d_ff 66 not divisible by tp 4"),
    ((32, 64, 62), "vocab_size 62 not divisible by tp 4"),
])
def test_non_dividing_dims_are_refused_by_name(dims, match):
    """The kernels' split dims, as the reference's GSPMD refuses them;
    the head count is free (``test_torch_tp_heads.py``)."""
    with pytest.raises(ValueError, match=match):
        check_tp_dims(*dims, 4)
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(drive.config(1), d_model=dims[0], n_heads=2,
                            d_ff=dims[1], vocab_size=dims[2], tp=4)


def test_a_model_and_its_tensor_axis_agree():
    model = tlm.make_model(drive.config(2))
    alg = talg.all_reduce(StackedTransport(1))
    for tp in (None, StackedTp(4)):
        with pytest.raises(ValueError, match="a model of tp 2"):
            tlm.build_lm_train_step(model, alg, sgd(), lambda *a: 0.1, 1,
                                    tp=tp)
    with pytest.raises(ValueError, match="a model of tp 1"):
        tlm.build_lm_train_step(tlm.make_model(drive.config(1)), alg,
                                sgd(), lambda *a: 0.1, 1, tp=StackedTp(2))


# -- against the reference ------------------------------------------------


def _jax_run(dp, sp, tp, batches):
    """The reference's tp step on its CPU mesh: ``(gossip, tp)`` with
    ``init_lm_state_tp`` at sp 1, ``(gossip, seq, tp)`` with ring
    attention at sp > 1."""
    import jax

    from stochastic_gradient_push_tpu import algorithms as jalg
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import LRSchedule as JLR
    from stochastic_gradient_push_tpu.train import sgd as jsgd
    from stochastic_gradient_push_tpu.train.lm import (
        SEQ_AXIS, build_lm_train_step, init_lm_state, init_lm_state_tp,
        make_dp_sp_tp_mesh, make_dp_tp_mesh, shard_lm_train_step)

    seq_axis = SEQ_AXIS if sp > 1 else None
    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                        d_ff=FF, max_len=T,
                        attn_impl="ring" if sp > 1 else "full",
                        seq_axis=seq_axis))
    alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=1)), GOSSIP_AXIS)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lrs = JLR(ref_lr=0.5, batch_size=B, world_size=dp, decay_schedule={},
              warmup=True)
    step = build_lm_train_step(model, alg, tx, lrs, itr_per_epoch=2,
                               seq_axis=seq_axis)
    if sp == 1:
        mesh = make_dp_tp_mesh(dp, tp)
        state = init_lm_state_tp(model, mesh, alg, tx, dp=dp, batch_size=B,
                                 seq_len=T, seed=0)
    else:
        mesh = make_dp_sp_tp_mesh(dp, sp, tp)
        state = init_lm_state(model, mesh, alg, tx, dp=dp, sp=sp,
                              batch_size=B, block_len=T // sp, seed=0,
                              seq_axis=seq_axis)
    fn = shard_lm_train_step(step, mesh, seq_axis=seq_axis, tp=True)
    start = jax.device_get(state)
    metrics = []
    for toks, tgts in batches:
        if sp == 1:
            toks, tgts = toks[:, 0], tgts[:, 0]
        state, m = fn(state, toks, tgts)
        metrics.append(jax.device_get(m))
    return start, jax.device_get(state), metrics


@pytest.mark.parametrize("dp,sp,tp", [(4, 1, 2), (2, 2, 2)])
def test_tp_step_matches_the_reference(dp, sp, tp):
    batches = drive.batches(dp, sp, 3)
    start, end, metrics = _jax_run(dp, sp, tp, batches)
    ax = StackedTp(tp)
    cfg = drive.config(tp, "ring" if sp > 1 else "full")
    transport = StackedTransport(dp)
    alg = talg.sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1)), transport)
    step = tlm.build_lm_train_step(
        tlm.make_model(cfg), alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.5, B, dp, decay_schedule={}, warmup=True),
        itr_per_epoch=2, seq=StackedSeq(sp) if sp > 1 else None, tp=ax)
    state = shard_state(train_state_from_jax(start), tp)
    for (toks, tgts), want in zip(batches, metrics):
        x, y = (torch.from_numpy(a if sp > 1 else a[:, 0]).long()
                for a in (toks, tgts))
        state, m = step(state, x, y)
        np.testing.assert_allclose(m["loss"].numpy(),
                                   np.asarray(want["loss"]).reshape(-1),
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   np.asarray(want["grad_norm"]).reshape(-1),
                                   rtol=GN_RTOL, atol=0)
    ref = train_state_from_jax(end)
    got = gather_state(state, tp)
    for n, w in ref.params.items():
        np.testing.assert_allclose(got.params[n].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        np.testing.assert_allclose(got.opt_state[n].numpy(),
                                   ref.opt_state[n].numpy(), rtol=0,
                                   atol=lm_drive.MOM_ATOL, err_msg=n)
    assert torch.equal(state.gossip.ps_weight, ref.gossip.ps_weight)
    # the converters place and gather the reference's tree
    sharded = params_from_jax(end.params, tp)
    assert all(torch.equal(sharded[n], p) for n, p in
               shard_params(ref.params, tp).items())
    flat = params_to_jax(sharded, tp)
    assert np.array_equal(flat["lm_head"]["kernel"],
                          np.asarray(end.params["lm_head"]["kernel"]))


# -- against the port's tp = 1 --------------------------------------------


def _port(name, tp, dtype=torch.float32, impl="full", remat=False,
          dp=2):
    ax = StackedTp(tp) if tp > 1 else None
    out = drive.run(name, dp, StackedTransport(dp), None, ax,
                    drive.batches(dp, 1, 7), impl=impl, remat=remat,
                    dtype=dtype)
    params = {k[7:]: torch.from_numpy(v) for k, v in out.items()
              if k.startswith("params/")}
    momentum = {k[9:]: torch.from_numpy(v) for k, v in out.items()
                if k.startswith("momentum/")}
    if tp > 1:
        params, momentum = (gather_params(t, tp) for t in (params,
                                                            momentum))
    return out, params, momentum


@pytest.fixture(scope="module")
def tp1():
    torch.set_num_threads(1)
    return {(name, dtype): _port(name, 1, dtype)
            for name in ("sgp", "osgp", "allreduce")
            for dtype in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["sgp", "osgp", "allreduce"])
def test_tp_equals_tp1_fp32(tp1, name, tp):
    want, wp, wm = tp1[name, torch.float32]
    got, gp, gm = _port(name, tp)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"loss/{i}"], want[f"loss/{i}"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(got[f"grad_norm/{i}"],
                                   want[f"grad_norm/{i}"], rtol=GN_RTOL,
                                   atol=0)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=LOSS_RTOL, atol=0)
    assert lm_drive.tree_err(gp, wp) <= PARAM_ATOL
    assert lm_drive.tree_err(gm, wm) <= PARAM_ATOL
    assert np.array_equal(got["ps_weight"], want["ps_weight"])
    for k in want:
        if k.startswith("in_flight/"):
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["sgp", "osgp", "allreduce"])
def test_tp_equals_tp1_bf16(tp1, name, tp):
    want, wp, _ = tp1[name, torch.bfloat16]
    _, fp32, _ = tp1[name, torch.float32]
    got, gp, _ = _port(name, tp, torch.bfloat16)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"loss/{i}"], want[f"loss/{i}"],
                                   rtol=lm_drive.BF16_LOSS_RTOL, atol=0)
    lm_drive.assert_bf16_params(gp, wp, fp32)
    assert np.array_equal(got["ps_weight"], want["ps_weight"])


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_remat_reads_back_its_sums(impl):
    """With remat each block's forward runs again in the backward; its
    sums over the shards are read back from the first pass (the same
    count as without remat), and the run is bit-equal to no remat."""
    a, _, _ = _port("sgp", 2, impl=impl, remat=True)
    b, _, _ = _port("sgp", 2, impl=impl, remat=False)
    assert int(a["reductions"]) == int(b["reductions"]) > 0
    for k in b:
        assert np.array_equal(a[k], b[k]), k
    # a step's sums a replica: f's backward for ln1, ln2 (each layer) and
    # ln_f, g after o and down, the loss's max, exp-sum and target, the
    # grad norm; the eval step's g and loss sums
    per_step = 2 * L + 1 + 2 * L + 3 + 1
    assert int(b["reductions"]) == 2 * (STEPS * per_step + 2 * L + 3)


def test_the_held_heads_fold_into_one_attention():
    """The stacked lane folds its shards' heads into one head dim: one
    flash call a layer, as at tp 1."""
    from stochastic_gradient_push_torch.models import transformer

    calls = []
    real = transformer.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    transformer.flash_attention = spy
    try:
        _port("sgp", 2, impl="flash")
    finally:
        transformer.flash_attention = real
    # three train steps and the eval step of 2 replicas, L layers each,
    # all H heads
    assert calls == [(B, H, T, D // H)] * (2 * L * (STEPS + 1))


# -- the int8 wire ---------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_blocks_of_a_shard_are_the_references(tp):
    """Each split leaf's shards, blocked in the reference's ``[in, out]``
    order (``reference_layout``), give the reference codec's codes and
    scales of the logical leaf's blocks, bit for bit."""
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.wire import (
        Int8Codec as JInt8)

    block = 8
    cfg = drive.config(tp)
    layout = tlm.reference_layout(tlm.make_model(cfg))
    rng = np.random.default_rng(3)
    logical = {n: torch.from_numpy(rng.normal(size=(2, *shape))
                                   .astype(np.float32))
               for n, shape in tlm.logical_shapes(cfg).items()}
    sharded = shard_params(logical, tp)
    codec, encode = Int8Codec(block), jax.jit(JInt8(block).encode)
    for n, p in sharded.items():
        d = split_dim(n)
        if d is None:
            continue
        q, scale = codec.encode(collectives._to_ref(p, layout.perm(n)))
        for r in range(2):
            leaf = logical[n][r].numpy()
            leaf = leaf.T if leaf.ndim == 2 else leaf      # [in, out]
            # the compiled encode, as the reference's round runs it
            rq, rs = (np.asarray(x) for x in encode(jnp.asarray(leaf)))
            rq, rs = rq.reshape(-1, block), rs.reshape(-1)
            if d == 0 and leaf.ndim == 2:
                # a column shard: each row's out / tp columns, in blocks
                per = leaf.shape[1] // block
                idx = np.arange(rq.shape[0]).reshape(leaf.shape[0], tp,
                                                     per // tp)
                want = idx.transpose(1, 0, 2).reshape(-1)
            else:
                # a row shard (or a split bias): a contiguous run of blocks
                want = np.arange(rq.shape[0])
            np.testing.assert_array_equal(q[r].numpy().reshape(-1, block),
                                          rq[want], err_msg=n)
            np.testing.assert_array_equal(scale[r].numpy().reshape(-1),
                                          rs[want], err_msg=n)


def test_int8_round_on_shards_equals_the_logical_round():
    """One SGP step's gossip on the int8 wire: the round over the shards,
    gathered, equals the round over the logical leaves, bit for bit."""
    tp, dp = 2, 4
    rng = np.random.default_rng(5)
    cfg = drive.config(tp)
    logical = {n: torch.from_numpy(rng.normal(size=(dp, *s))
                                   .astype(np.float32))
               for n, s in tlm.logical_shapes(cfg).items()}
    outs = []
    for params, model in ((logical, tlm.make_model(drive.config(1))),
                          (shard_params(logical, tp),
                           tlm.make_model(cfg))):
        alg = drive.algorithm("sgp_int8", dp, StackedTransport(dp))
        alg.bind_layout(tlm.reference_layout(model))
        g = alg.init(params)
        p, g = alg.pre_step(params, g)
        p, g = alg.post_step(p, g)
        outs.append((p, g.ps_weight))
    got = gather_params(outs[1][0], tp)
    assert all(torch.equal(got[n], outs[0][0][n]) for n in logical)
    assert torch.equal(outs[0][1], outs[1][1])


def test_int8_wire_refuses_a_shard_that_cuts_a_block():
    shapes = tlm.logical_shapes(drive.config(1))
    check_wire_blocks(shapes, 2, 8)
    with pytest.raises(ValueError, match=r"block_0\.attn\.q\.weight's "
                                         r"shard has out / tp = 16"):
        check_wire_blocks(shapes, 2, 64)
    model = tlm.make_model(drive.config(2))
    alg = drive.algorithm("sgp", 2, StackedTransport(2))
    alg.wire = Int8Codec(64)
    with pytest.raises(ValueError, match="--wire_block 64"):
        tlm.build_lm_train_step(model, alg, sgd(), lambda *a: 0.1, 1,
                                tp=StackedTp(2))


# -- the command line's checkpoints ----------------------------------------

SMALL = ["--device", "cpu", "--vocab_size", "64", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "4", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--print_freq", "1",
         "--corpus_tokens", "4000", "--world_size", "4", "--tp", "2"]


def _rows(out: str) -> list:
    return [ln.split(",")[:4] + ln.split(",")[5:]
            for ln in out.splitlines() if ln.split(",")[0].isdigit()]


def test_cli_resume_equals_continue(tmp_path, capsys):
    """``--tp 2`` stacked: 4 steps straight equal 2 steps, then a resume
    to 4 (rows outside tokens/s, and the files); the files hold the
    logical leaves, as at tp 1."""
    def files(ckpt):
        return [torch.load(ckpt / f"lm_checkpoint_r{r}_n4.ckpt",
                           weights_only=True)["state"] for r in range(2)]

    straight, split = tmp_path / "straight", tmp_path / "split"
    gossip_lm.main(SMALL + ["--num_steps", "4", "--checkpoint_dir",
                            str(straight)])
    rows = _rows(capsys.readouterr().out)
    gossip_lm.main(SMALL + ["--num_steps", "2", "--checkpoint_dir",
                            str(split)])
    first = _rows(capsys.readouterr().out)
    for f in files(split):
        assert {n: tuple(t.shape) for n, t in f["params"].items()} == (
            tlm.logical_shapes(drive.config(1)))
    gossip_lm.main(SMALL + ["--num_steps", "4", "--resume", "True",
                            "--checkpoint_dir", str(split)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert len(rows) == 4 and first + _rows(out) == rows
    for a, b in zip(files(straight), files(split)):
        for part in ("params", "opt_state"):
            assert all(torch.equal(a[part][n], b[part][n])
                       for n in a[part]), part


@pytest.mark.parametrize("tp", [1, 4])
def test_logical_files_load_at_another_tp(tmp_path, tp):
    """A replica's file written at tp 2 (logical leaves) restores into a
    run at another tp: the same logical state, placed for its shards."""
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)

    dp = 2
    state = tlm.init_lm_state(drive.config(2), drive.algorithm(
        "osgp", dp, StackedTransport(dp)), sgd(), dp, seed=4,
        tp=StackedTp(2))
    rng = np.random.default_rng(1)
    state = dataclasses.replace(state, params={
        n: p + torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        for n, p in state.params.items()})
    saved = gather_state(state, 2)
    CheckpointManager(str(tmp_path), world_size=4, ranks=range(dp)).save(
        saved, {"step": 5})
    ax = StackedTp(tp) if tp > 1 else None
    template = tlm.init_lm_state(drive.config(tp), drive.algorithm(
        "osgp", dp, StackedTransport(dp)), sgd(), dp, seed=0, tp=ax)
    got, meta = CheckpointManager(str(tmp_path), world_size=4,
                                  ranks=range(dp)).restore(
        template if ax is None else gather_state(template, tp))
    if ax is not None:
        got = shard_state(got, tp)
    assert meta["step"] == 5
    want = saved if ax is None else shard_state(saved, tp)
    for part in ("params", "opt_state"):
        a, b = getattr(got, part), getattr(want, part)
        assert all(torch.equal(a[n], b[n]) for n in b), part
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        assert torch.equal(gw, ww)
        assert all(torch.equal(gp[n], wp[n]) for n in wp)


ALGORITHM_FLAGS = {
    "sgp": [], "osgp": ["--overlap", "True", "--staleness", "2"],
    "dpsgd": ["--push_sum", "False"], "adpsgd": ["--bilat", "True"],
    "allreduce": ["--all_reduce", "True"]}


@pytest.mark.parametrize("name", sorted(ALGORITHM_FLAGS))
@pytest.mark.parametrize("mesh", [
    ["--tp", "2"],
    ["--tp", "4", "--world_size", "8", "--precision", "bf16"],
    ["--tp", "2", "--world_size", "8", "--sp", "2", "--attn", "ring_flash",
     "--precision", "bf16"],
])
def test_cli_trains_every_algorithm(tmp_path, capsys, name, mesh):
    """Each algorithm through the command line, stacked, at tp 2 (fp32),
    tp 4 (bf16) and dp 2 x sp 2 x tp 2 (bf16, ring_flash): finite rows,
    the layout named in the log line, the gossip between the replicas."""
    result = gossip_lm.main(SMALL + ALGORITHM_FLAGS[name] + mesh + [
        "--num_steps", "2", "--checkpoint_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(result["final_loss"])
    tp = mesh[1]
    sp = " x sp 2" if "--sp" in mesh else ""
    world = 8 if "8" in mesh else 4
    assert f"world {world} = dp 2{sp} x tp {tp} (2 in this process)" in out


def test_cli_refuses_cross_world_resume_at_tp(tmp_path):
    """A resume at --tp 2 over a checkpoint set of another world is
    refused by name, as at --sp 2: the reference reshards flat dp meshes
    only."""
    (tmp_path / "lm_checkpoint_r0_n2.ckpt").write_bytes(b"")
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .*world \[2\].*--tp 2 > 1"):
        gossip_lm.main(SMALL + ["--num_steps", "2", "--resume", "True",
                                "--checkpoint_dir", str(tmp_path)])
