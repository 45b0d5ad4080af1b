"""The switch MoE layer (``models/moe.py``) and the MoE transformer held
against the reference (``stochastic_gradient_push_tpu/models/moe.py``,
``models/transformer.py``) on the CPU, at ``tests/test_moe.py``'s sizes
(T32, D8, F16, E8, ep 4), on numpy inputs from a seed.

* **Routing, exactly.**  Each token's expert, its queue position, the
  kept mask, the capacity and the dropped fraction equal the
  reference's: its router probabilities from ``jax.jit`` of its
  ``softmax(x @ router)``, its argmax and int cumsum.  The inputs' smallest
  top-1 / top-2 probability margin is asserted above 1e-5, far above the
  ~1e-7 the two frameworks' fp32 products can differ by, so no argmax can
  flip by rounding.
* **The slots, bit for bit**: the index form's ``[E, C, D]`` against the
  reference's one-hot dispatch einsum under ``jax.jit``.
* **Outputs and gradients**: ``y`` atol 1e-6, the load-balancing loss
  rtol 1e-6, the gradients of ``Σ y² + 0.01 · lb`` with respect to ``x``,
  the router and both expert stacks rtol 1e-5 / atol 1e-6 (fp32 products
  in another order; they sit ~1e-7 apart).
* **The ep exchange**: a :class:`StackedEp` of 4 shards against the
  reference's ``shard_map`` over its ``ep`` axis (atol 1e-6, dropped
  fractions equal) and against one shard holding every expert (equal).
* **The model**: ring per-block routing at sp 2 against the full model
  (the reference's own parity test, 2e-4) and against the reference's
  logits; remat on and off give the same loss and gradients and collect
  each block's aux once; the converters carry the MoE leaves.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.models import moe as pmoe
from stochastic_gradient_push_torch.models.convert import (
    config_from_params, init_params, params_from_jax, params_to_jax,
    reference_layout)
from stochastic_gradient_push_torch.models.transformer import TransformerLM
from stochastic_gradient_push_torch.parallel.ep import StackedEp
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.train import lm as tlm
import torch_ep_drive as drive

EP = 4
T, D, F, E = 32, 8, 16, 8
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(D, E)).astype(np.float32) * 0.5,
            rng.normal(size=(E, D, F)).astype(np.float32) * 0.3,
            rng.normal(size=(E, F, D)).astype(np.float32) * 0.3)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _ref_routing(x, router, cap):
    """The reference's routing: its probabilities under ``jax.jit``, then
    its argmax, take and int cumsum (``models/moe.py:64-73`` there)."""
    import jax
    import jax.numpy as jnp

    probs = np.asarray(jax.jit(lambda a, r: jax.nn.softmax(
        (a @ r).astype(jnp.float32), axis=-1))(x, router))
    expert = probs.argmax(-1)
    onehot = np.eye(router.shape[-1], dtype=np.int32)[expert]
    pos = np.take_along_axis(np.cumsum(onehot, 0), expert[:, None],
                             -1)[:, 0] - 1
    top = np.take_along_axis(probs, expert[:, None], -1)[:, 0]
    srt = np.sort(probs, -1)
    return probs, expert, pos, pos < cap, top, float(
        (srt[:, -1] - srt[:, -2]).min())


def _ref_slots(x, router, cap):
    """The reference's slots: its one-hot dispatch and einsum
    (``models/moe.py:64-80`` there) under ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    def slots(x, router_w):
        e_total = router_w.shape[-1]
        probs = jax.nn.softmax((x @ router_w).astype(jnp.float32), axis=-1)
        expert_idx = jnp.argmax(probs, axis=-1)
        onehot = jax.nn.one_hot(expert_idx, e_total, dtype=jnp.float32)
        cum = jnp.cumsum(onehot.astype(jnp.int32), axis=0)
        pos = jnp.take_along_axis(cum, expert_idx[:, None], axis=-1)[:, 0] - 1
        kept = pos < cap
        slot = jax.nn.one_hot(jnp.where(kept, pos, cap), cap,
                              dtype=jnp.float32)
        dispatch = onehot[:, :, None] * slot[:, None, :]
        return jnp.einsum("tec,td->ecd", dispatch, x.astype(jnp.float32))

    return np.asarray(jax.jit(slots)(x, router))


@pytest.mark.parametrize("tokens,experts,cf", [
    (32, 8, 1.25), (8192, 8, 1.25), (7, 8, 1.25), (100, 3, 0.7),
    (4096, 8, 8.0), (1, 64, 1.0)])
def test_capacity_is_the_references(tokens, experts, cf):
    from stochastic_gradient_push_tpu.models.moe import moe_capacity

    assert pmoe.moe_capacity(tokens, experts, cf) == moe_capacity(
        tokens, experts, cf)


@pytest.mark.parametrize("seed,cf", [(1, 1.25), (2, 0.5), (3, 4.0)])
def test_routing_is_the_references(weights, seed, cf):
    router = weights[0]
    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)
    cap = pmoe.moe_capacity(T, E, cf)
    probs, expert, pos, kept, top, margin = _ref_routing(x, router, cap)
    assert margin > MARGIN, margin
    got = pmoe.route(*_t(x, router), cap)
    assert np.array_equal(got.expert.numpy(), expert)
    assert np.array_equal(got.pos.numpy(), pos)
    assert np.array_equal(got.kept.numpy(), kept)
    np.testing.assert_allclose(got.probs.numpy(), probs, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.top.numpy(), top, rtol=1e-6)
    from stochastic_gradient_push_tpu.models.moe import switch_moe_ffn

    import jax

    _, aux = jax.jit(lambda *a: switch_moe_ffn(*a, capacity_factor=cf))(
        x, *weights)
    _, paux = pmoe.switch_moe_ffn(*_t(x, *weights), capacity_factor=cf)
    assert float(paux["dropped_fraction"]) == float(aux["dropped_fraction"])
    assert float(paux["dropped_fraction"]) == 1 - kept.mean()
    if cf < 1:
        assert not kept.all()


@pytest.mark.parametrize("seed,cf", [(1, 1.25), (2, 0.5)])
def test_slots_are_the_references_bit_for_bit(weights, seed, cf):
    router = weights[0]
    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)
    cap = pmoe.moe_capacity(T, E, cf)
    assert _ref_routing(x, router, cap)[-1] > MARGIN
    tx, tr = _t(x, router)
    slots, slot = pmoe.dispatch(tx, pmoe.route(tx, tr, cap), E, cap)
    want = _ref_slots(x, router, cap)
    assert slots.shape == want.shape == (E, cap, D)
    assert np.array_equal(slots.numpy(), want)
    # a dropped token points one past the slots
    kept = pmoe.route(tx, tr, cap).kept
    assert bool((slot[~kept] == E * cap).all())


@pytest.mark.parametrize("seed", [1, 4])
def test_outputs_and_gradients_match_the_reference(weights, seed):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.models.moe import switch_moe_ffn

    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)
    assert _ref_routing(x, weights[0],
                        pmoe.moe_capacity(T, E))[-1] > MARGIN

    def ref_loss(x, r, w1, w2):
        y, aux = switch_moe_ffn(x, r, w1, w2)
        return jnp.sum(y ** 2) + 0.01 * aux["load_balance_loss"], (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3), has_aux=True))(x, *weights)
    ins = [t.requires_grad_(True) for t in _t(x, *weights)]
    py, paux = pmoe.switch_moe_ffn(*ins)
    assert float(np.abs(np.asarray(y)).max()) > 0.01
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(paux["load_balance_loss"].detach()),
                               float(aux["load_balance_loss"]), rtol=1e-6)
    loss = (py ** 2).sum() + 0.01 * paux["load_balance_loss"]
    got = torch.autograd.grad(loss, ins)
    for name, g, w in zip(("x", "router", "w1", "w2"), got, grads):
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_all_tokens_to_one_expert_drop_past_capacity():
    """The reference's ``test_moe_routing_and_capacity``: a router that
    sends every token to expert 0 keeps ``cap`` of them; the rest get a
    zero output (the residual carries them)."""
    router = np.zeros((D, E), np.float32)
    router[0, 0] = 100.0
    y, aux = pmoe.switch_moe_ffn(*_t(np.ones((T, D), np.float32), router,
                                     np.ones((E, D, F), np.float32),
                                     np.ones((E, F, D), np.float32)))
    cap = pmoe.moe_capacity(T, E)
    assert float(aux["dropped_fraction"]) == (T - cap) / T
    assert int((y.abs().sum(-1) > 0).sum()) == cap


def test_ep_exchange_on_a_stack_matches_the_references(weights):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from stochastic_gradient_push_tpu.models.moe import switch_moe_ffn

    router, w1, w2 = weights
    x = np.random.default_rng(1).normal(size=(EP, T, D)).astype(np.float32)
    for s in range(EP):
        assert _ref_routing(x[s], router,
                            pmoe.moe_capacity(T, E))[-1] > MARGIN

    def sharded(xs, w1s, w2s):
        y, aux = switch_moe_ffn(xs[0], router, w1s, w2s, ep_axis="ep")
        return y[None], jax.tree.map(lambda a: a[None], aux)

    mesh = Mesh(np.array(jax.devices()[:EP]), ("ep",))
    y_ref, aux_ref = jax.jit(jax.shard_map(
        sharded, mesh=mesh, in_specs=(P("ep"), P("ep"), P("ep")),
        out_specs=(P("ep"), P("ep"))))(x, w1, w2)
    ep = StackedEp(EP)
    y, aux = pmoe.switch_moe_ffn(*_t(x, router, w1, w2), ep=ep)
    assert y.shape == (EP, T, D) and ep.exchanges == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=1e-6)
    assert np.array_equal(aux["dropped_fraction"].numpy(),
                          np.asarray(aux_ref["dropped_fraction"]))
    np.testing.assert_allclose(aux["load_balance_loss"].numpy(),
                               np.asarray(aux_ref["load_balance_loss"]),
                               rtol=1e-6)
    # one shard holding every expert routes each shard's tokens alike
    for s in range(EP):
        y1, _ = pmoe.switch_moe_ffn(*_t(x[s], router, w1, w2))
        assert torch.equal(y1, y[s])


def test_ep_exchange_keeps_shard_order():
    """Expert ``e``'s rows after the exchange are each source shard's
    ``C`` slots in shard order (``concat_axis=1, tiled=True``)."""
    ep = StackedEp(2)
    slots = torch.arange(2 * 4 * 3 * 1.0).reshape(2, 4, 3, 1)  # [ep,E,C,D]
    xs = ep.dispatch(slots)
    assert xs.shape == (4, 6, 1)
    for e in range(4):
        assert torch.equal(xs[e, :3, 0], slots[0, e, :, 0])
        assert torch.equal(xs[e, 3:, 0], slots[1, e, :, 0])
    assert torch.equal(ep.combine(xs, (), 3), slots)


@pytest.mark.parametrize("router_e,match", [(4, "router is over 4 experts"),
                                            (6, "router is over 6 experts")])
def test_router_size_is_checked(router_e, match):
    with pytest.raises(ValueError, match=match):
        pmoe.switch_moe_ffn(torch.ones(4, D), torch.ones(D, router_e),
                            torch.ones(E, D, F), torch.ones(E, F, D))
    with pytest.raises(ValueError, match="router"):
        pmoe.switch_moe_ffn(torch.ones(2, 4, D), torch.ones(D, router_e),
                            torch.ones(E, D, F), torch.ones(E, F, D),
                            ep=StackedEp(2))


# -- the model -------------------------------------------------------------


def _jax_model(impl="full", seq_axis=None, cf=8.0, experts=4):
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)

    return JLM(JConfig(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                       d_ff=32, max_len=32, attn_impl=impl,
                       seq_axis=seq_axis, moe_experts=experts, moe_every=2,
                       moe_capacity_factor=cf))


def _port_cfg(impl="full", cf=8.0, remat=False, experts=4):
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)

    return TransformerConfig(vocab_size=64, d_model=16, n_layers=2,
                             n_heads=2, d_ff=32, attn_impl=impl, remat=remat,
                             moe_experts=experts, moe_every=2,
                             moe_capacity_factor=cf)


def test_ring_per_block_routing_matches_the_full_model():
    """MoE x ring at sp 2: each sequence shard routes its own block under
    its own capacity; with room for every token the sharded model equals
    the full-attention one (the reference's
    ``test_moe_ring_per_block_routing_parity``), and both equal the
    reference's full-attention logits."""
    import jax
    import jax.numpy as jnp

    b, t, sp = 2, 32, 2
    toks = np.random.default_rng(11).integers(0, 64, size=(b, t))
    ref = _jax_model()
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(toks, jnp.int32))[
        "params"]
    want, _ = jax.jit(lambda p, x: ref.apply(
        {"params": p}, x, mutable=["losses", "moe_metrics"]))(params, toks)
    z = params_from_jax(params)
    full = tlm.make_model(_port_cfg())
    ring = tlm.make_model(_port_cfg("ring"))
    x = torch.from_numpy(toks).long()
    aux_full, aux_ring = [], []
    from torch.func import functional_call

    got_full = functional_call(full, z, (x, None, None, None, aux_full))
    blocks = x.reshape(b, sp, t // sp).transpose(0, 1)
    got_ring = functional_call(ring, z, (blocks, StackedSeq(sp), None, None,
                                         aux_ring))
    got_ring = got_ring.transpose(0, 1).reshape(b, t, -1)
    np.testing.assert_allclose(got_ring.detach().numpy(),
                               got_full.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_full.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    # one MoE block: a value for the flat model, one a shard for the ring
    assert [tuple(lb.shape) for lb, _ in aux_full] == [()]
    assert [tuple(lb.shape) for lb, _ in aux_ring] == [(sp,)]
    assert float(aux_ring[0][1].max()) == 0.0


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_remat_gives_the_same_loss_and_grads(impl):
    """A rematerialised MoE block's aux leaves the checkpoint as outputs:
    one entry a block, the same objective and gradients as without
    remat, bit for bit on the CPU."""
    from torch.func import functional_call

    cfg = _port_cfg(impl, cf=1.0)
    z = params_from_jax(init_params(cfg, 3))
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 64, size=(2, 32))).long()
    out = []
    for remat in (False, True):
        model = tlm.make_model(_port_cfg(impl, cf=1.0, remat=remat))
        zr = {n: p.clone().requires_grad_(True) for n, p in z.items()}
        aux = []
        logits = functional_call(model, zr, (x, None, None, None, aux))
        assert len(aux) == 1
        loss = tlm.lm_loss(logits, x) + 0.01 * aux[0][0]
        grads = torch.autograd.grad(loss, list(zr.values()))
        assert len(aux) == 1    # the recompute appended nothing
        out.append((loss.detach(), aux[0][1], grads))
    (l0, d0, g0), (l1, d1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(d0, d1) and float(d0) > 0
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_the_converters_carry_the_moe_leaves():
    import jax
    import jax.numpy as jnp

    ref = _jax_model(experts=8)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 32), jnp.int32))["params"])
    port = params_from_jax(params)
    model = TransformerLM(_port_cfg(experts=8))
    assert {n: tuple(p.shape) for n, p in port.items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    assert torch.equal(port["block_1.moe.experts_up"],
                       torch.from_numpy(np.array(params["block_1"]["moe"][
                           "experts_up"])))
    back = params_to_jax(port)
    assert np.array_equal(back["block_1"]["moe"]["router"],
                          params["block_1"]["moe"]["router"])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    cfg = config_from_params(params, 2)
    assert (cfg.moe_experts, cfg.moe_every, cfg.d_ff) == (8, 2, 32)
    # the reference's flatten order, with no permutation on the raw leaves
    layout = reference_layout(model)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(layout.order)
    for (path, _), name in zip(flat, layout.order):
        keys = [p.key for p in path]
        assert name.split(".")[:-1] == keys[:-1]
    assert not any("moe" in n for n in layout.perms)


def test_init_draws_the_flax_recipe():
    """``init_params`` draws the router N(0, 0.02) and the expert stacks
    lecun-normal with flax's fan-in, which counts the expert dim (E·in),
    as the reference's init does."""
    import jax
    import jax.numpy as jnp

    cfg = drive.config()
    tree = init_params(cfg, 0)
    assert "up" not in tree["block_1"] and "moe" not in tree["block_0"]
    moe = tree["block_1"]["moe"]
    ref = _jax_model(experts=drive.E)
    ref_cfg_model = type(ref)(ref.cfg._replace(
        d_model=drive.D, d_ff=drive.FF, n_heads=drive.H,
        vocab_size=drive.VOCAB))
    shapes = jax.eval_shape(lambda: ref_cfg_model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32)))["params"]
    for leaf in ("router", "experts_up", "experts_down"):
        assert moe[leaf].shape == shapes["block_1"]["moe"][leaf].shape
    e, d, f = drive.E, drive.D, drive.FF
    big = init_params(drive.config(), 1)["block_1"]["moe"]
    assert abs(float(np.std(big["router"])) - 0.02) < 0.004
    assert abs(float(np.std(moe["experts_up"])) - (e * d) ** -0.5) < 0.05 * (
        e * d) ** -0.5
    assert abs(float(np.std(moe["experts_down"])) - (e * f) ** -0.5) < (
        0.05 * (e * f) ** -0.5)
    assert float(np.abs(moe["experts_up"]).max()) < 2 * (e * d) ** -0.5 / (
        0.87962566103423978)


@pytest.mark.parametrize("kw,match", [
    ({"moe_every": 0}, "moe_every must be >= 1"),
    ({"ep": 3}, "moe_experts 8 not divisible by ep 3"),
    ({"moe_experts": 0, "ep": 2}, "--ep requires --moe_experts"),
    # MoE under tp splits each expert's F evenly
    ({"tp": 2, "d_ff": 31}, "d_ff 31 not divisible by tp 2"),
])
def test_config_refusals(kw, match):
    import dataclasses

    with pytest.raises(ValueError, match=match):
        dataclasses.replace(drive.config(), **kw)


@pytest.mark.parametrize("shape", [(1000,), (37, 53), (4, 16, 32)])
def test_truncated_normal_redraws_as_the_whole_array_rescan(shape):
    """``_lecun_normal`` redraws only its rejected entries each round; the
    values are those of redrawing every entry still outside (-2, 2) after
    a rescan of the whole array, draw for draw."""
    from stochastic_gradient_push_torch.models.convert import _lecun_normal

    for seed in range(3):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(shape, dtype=np.float32)
        bad = np.abs(x) >= 2.0
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(x) >= 2.0
        want = x * np.float32(7 ** -0.5 / 0.87962566103423978)
        got = _lecun_normal(np.random.default_rng(seed), 7, shape)
        assert got.dtype == np.float32 and np.array_equal(got, want)
