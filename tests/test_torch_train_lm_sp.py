"""Port parity: the sequence-parallel LM step (``stochastic_gradient_push_
torch.train.lm`` with a ring model over a ``StackedSeq``) against the JAX
package's ``build_lm_train_step(seq_axis=SEQ_AXIS)`` under
``shard_lm_train_step`` on its ``(gossip, seq)`` CPU mesh, from one state
and on the same numpy token batches ``[dp, sp, batch, t]``.

Both start from the reference's own ring init, carried across by
``models/convert.py::train_state_from_jax``.  Three steps at dp 2 x sp 2
and dp 1 x sp 4, ``ring`` and ``ring_flash`` (the reference's plain tick
on the CPU, the port's plain twins), remat on and off, SGP, one OSGP
case; ``blockwise`` at sp 1 on the flat mesh.  Tolerances as
``test_torch_train_lm.py``: losses within 1e-5 relative, grad norms 1e-4
relative, params and momentum after three steps atol 2e-6, the push-sum
weight and the phase exactly equal; OSGP momentum as the flat OSGP test
holds it (``MOM_ATOL``, and its distance from an fp64 run, here the flat
fp64 step over the whole sequences, at most twice the reference's).  On
the port alone: remat on equals remat off exactly on the CPU (the
recompute repeats the same ops), and ``grad_accum 2`` at sp 2 equals
``grad_accum 1`` within 1e-6.

bf16, with the flat file's distance rules (``test_torch_train_lm.py``,
where their reasons are written): the ``ring_flash`` forward's logits at
dp 1 x sp 2, and three SGP steps at dp 2 x sp 2 with ``ring_flash``,
remat on and off, each between half and twice the reference's
bf16-to-fp32 distance from its fp32 run.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    init_params, params_from_jax, train_state_from_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
import torch_lm_drive as drive

torch.set_num_threads(1)

VOCAB, D, L, H, FF, T, B = 64, 64, 2, 1, 128, 32, 2
STEPS = 3
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6


def _cfg_kw(impl, remat, dtype="float32"):
    return dict(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                attn_impl=impl, remat=remat, dtype=getattr(torch, dtype))


def _jax_run(dp, sp, impl, remat, alg_name, batches, seed=0,
             dtype="float32"):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu import algorithms as jalg
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)
    from stochastic_gradient_push_tpu.train import LRSchedule as JLR
    from stochastic_gradient_push_tpu.train import sgd as jsgd
    from stochastic_gradient_push_tpu.train.lm import (
        SEQ_AXIS, build_lm_train_step, init_lm_state, make_dp_sp_mesh,
        shard_lm_train_step)

    ring = impl in ("ring", "ring_flash")
    seq_axis = SEQ_AXIS if ring else None
    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                        d_ff=FF, max_len=T, attn_impl=impl,
                        seq_axis=seq_axis, remat=remat,
                        dtype=getattr(jnp, dtype)))
    mesh = make_dp_sp_mesh(dp, sp) if ring else make_gossip_mesh(dp)
    if alg_name == "sgp":
        alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=1)), GOSSIP_AXIS)
    else:
        alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=1)), GOSSIP_AXIS,
                       overlap=True, staleness=2)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lrs = JLR(ref_lr=0.5, batch_size=B, world_size=dp, decay_schedule={},
              warmup=True)
    step = shard_lm_train_step(
        build_lm_train_step(model, alg, tx, lrs, itr_per_epoch=2,
                            seq_axis=seq_axis), mesh, seq_axis=seq_axis)
    state = init_lm_state(model, mesh, alg, tx, dp=dp, sp=sp, batch_size=B,
                          block_len=T // sp, seed=seed, seq_axis=seq_axis)
    start = jax.device_get(state)
    metrics = []
    for toks, tgts in batches:
        if not ring:
            toks, tgts = toks[:, 0], tgts[:, 0]
        state, m = step(state, toks, tgts)
        metrics.append(jax.device_get(m))
    return start, jax.device_get(state), metrics


def _port_step(dp, sp, impl, remat, alg_name, grad_accum=1,
               dtype="float32"):
    transport = StackedTransport(dp)
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1))
    if alg_name == "sgp":
        alg = talg.sgp(sched, transport)
    else:
        alg = talg.osgp(sched, transport, staleness=2)
    cfg = TransformerConfig(**_cfg_kw(impl, remat, dtype))
    step = tlm.build_lm_train_step(
        tlm.make_model(cfg), alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.5, B, dp, decay_schedule={}, warmup=True),
        itr_per_epoch=2, grad_accum=grad_accum,
        seq=StackedSeq(sp) if cfg.ring else None)
    return cfg, alg, step


def _port_run(dp, sp, impl, remat, alg_name, start, batches, grad_accum=1,
              dtype="float32"):
    cfg, _, step = _port_step(dp, sp, impl, remat, alg_name, grad_accum,
                              dtype)
    state = start if isinstance(start, tlm.TrainState) else \
        train_state_from_jax(start)
    if dtype == "float64":
        state = drive.fp64_state(state)
    metrics = []
    for toks, tgts in batches:
        toks, tgts = (torch.from_numpy(a).long() for a in (toks, tgts))
        if not cfg.ring:
            toks, tgts = toks[:, 0], tgts[:, 0]
        state, m = step(state, toks, tgts)
        metrics.append(m)
    return state, metrics


def _batches(dp, sp, seed):
    r = np.random.default_rng(seed)
    return [tuple(r.integers(0, VOCAB, size=(dp, sp, B, T // sp)).astype(
        np.int32) for _ in range(2)) for _ in range(STEPS)]


def _whole(batches):
    """``[dp, sp, B, t]`` batches as ``[dp, 1, B, sp * t]``: each
    replica's whole sequences, for a flat model."""
    return [tuple(np.concatenate(list(np.moveaxis(a, 1, 0)), axis=-1)[:, None]
                  for a in pair) for pair in batches]


def _assert_matches(want, jm, got, tm, momentum=True):
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"].numpy(),
                                   np.asarray(j["loss"]).reshape(-1),
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["ppl"].numpy(),
                                   np.asarray(j["ppl"]).reshape(-1),
                                   rtol=2 * LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["grad_norm"].numpy(),
                                   np.asarray(j["grad_norm"]).reshape(-1),
                                   rtol=GN_RTOL, atol=0)
        assert np.float32(t["lr"]) == np.asarray(j["lr"]).reshape(-1)[0]
    for name, w in params_from_jax(want.params).items():
        np.testing.assert_allclose(got.params[name].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    trace = [s.trace for s in want.opt_state if hasattr(s, "trace")][0]
    for name, w in params_from_jax(trace).items() if momentum else ():
        np.testing.assert_allclose(got.opt_state[name].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_array_equal(
        got.gossip.ps_weight.numpy(),
        np.asarray(want.gossip.ps_weight, np.float32).reshape(-1))
    assert got.gossip.phase == int(np.asarray(want.gossip.phase)[0])
    assert got.step == int(np.asarray(want.step)[0]) == STEPS


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
@pytest.mark.parametrize("dp,sp", [(2, 2), (1, 4)])
def test_sp_step_matches_reference(dp, sp, impl, remat):
    batches = _batches(dp, sp, 7 * dp + sp + len(impl))
    start, want, jm = _jax_run(dp, sp, impl, remat, "sgp", batches)
    got, tm = _port_run(dp, sp, impl, remat, "sgp", start, batches)
    _assert_matches(want, jm, got, tm)


def test_sp_osgp_step_matches_reference():
    """OSGP (staleness 2) at dp 2 x sp 2 with ring_flash, held as
    ``test_torch_train_lm.py`` holds the flat OSGP step: losses, grad
    norms, params, the push-sum weight and the in-flight FIFO (weights
    exactly equal, params within atol), momentum within ``MOM_ATOL`` and
    no farther from an fp64 run than twice the reference's (the flat
    fp64 step over the whole sequences: the same loss and gradient)."""
    batches = _batches(2, 2, 31)
    start, want, jm = _jax_run(2, 2, "ring_flash", False, "osgp", batches)
    got, tm = _port_run(2, 2, "ring_flash", False, "osgp", start, batches)
    _assert_matches(want, jm, got, tm, momentum=False)
    assert len(got.gossip.in_flight) == len(want.gossip.in_flight) == 2
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        np.testing.assert_array_equal(gw.numpy(), np.asarray(
            ww, np.float32).reshape(-1))
        for name, w in params_from_jax(wp).items():
            np.testing.assert_allclose(gp[name].numpy(), w.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    exact, _ = _port_run(2, 1, "full", False, "osgp", start,
                         _whole(batches), dtype="float64")
    trace = params_from_jax([s.trace for s in want.opt_state
                             if hasattr(s, "trace")][0])
    drive.assert_momentum(got.opt_state, trace, exact.opt_state)


def test_blockwise_step_matches_reference():
    """``blockwise`` at sp 1 on the flat mesh (key blocks of min(128, t)
    = 32: one block)."""
    batches = _batches(2, 1, 5)
    start, want, jm = _jax_run(2, 1, "blockwise", False, "sgp", batches)
    got, tm = _port_run(2, 1, "blockwise", False, "sgp", start, batches)
    _assert_matches(want, jm, got, tm)


def _fresh_state(dp, sp, impl, remat, alg_name="sgp"):
    cfg, alg, _ = _port_step(dp, sp, impl, remat, alg_name)
    return tlm.init_lm_state(cfg, alg, sgd(0.9, 1e-4, nesterov=True), dp,
                             seed=3)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_remat_equals_no_remat_exactly(impl):
    """The recompute repeats the forward's ops on the same inputs, so on
    the CPU the step with remat equals the step without, bit for bit."""
    batches = _batches(2, 2, 9)
    runs = [_port_run(2, 2, impl, remat, "sgp",
                      _fresh_state(2, 2, impl, remat), batches)
            for remat in (False, True)]
    (s1, m1), (s2, m2) = runs
    for a, b in zip(m1, m2):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name]), name


def test_grad_accum_splits_the_batch_not_the_shards():
    """Two microbatches of the batch dim at sp 2 give the full batch's
    step (the LM has no BatchNorm), within fp32 summation order."""
    batches = _batches(2, 2, 12)[:1]
    runs = [_port_run(2, 2, "ring_flash", False, "sgp",
                      _fresh_state(2, 2, "ring_flash", False), batches,
                      grad_accum=accum) for accum in (1, 2)]
    (s1, m1), (s2, m2) = runs
    torch.testing.assert_close(m1[0]["loss"], m2[0]["loss"], rtol=1e-6,
                               atol=0)
    for name in s1.params:
        torch.testing.assert_close(s1.params[name], s2.params[name],
                                   rtol=0, atol=1e-6)


def test_ring_models_need_their_sequence_axis():
    cfg, alg, _ = _port_step(1, 1, "flash", False, "sgp")
    with pytest.raises(ValueError, match="StackedSeq"):
        tlm.build_lm_train_step(tlm.make_model(cfg), alg, sgd(0.9), None, 1,
                                seq=StackedSeq(2))
    ring = TransformerConfig(**_cfg_kw("ring_flash", False))
    with pytest.raises(ValueError, match="StackedSeq"):
        tlm.build_lm_train_step(tlm.make_model(ring), alg, sgd(0.9), None, 1)


def test_ring_init_is_the_flat_init():
    """The weight map is unchanged by sequence parallelism: the
    reference's ring init at dp 2 x sp 2 (drawn under ``shard_map``) is
    its flat init from the same seed, leaf for leaf, on both replicas,
    and the port's ``init_params`` for a ring config is its flat one with
    the same tree, shapes and dtypes as the reference's."""
    import jax

    start, _, _ = _jax_run(2, 2, "ring", False, "sgp", [])
    flat, _, _ = _jax_run(2, 1, "flash", False, "sgp", [])
    ring_p = params_from_jax(jax.tree.map(lambda a: a[0], start.params))
    ring_1 = params_from_jax(jax.tree.map(lambda a: a[1], start.params))
    flat_p = params_from_jax(jax.tree.map(lambda a: a[0], flat.params))
    assert ring_p.keys() == flat_p.keys()
    for name, p in ring_p.items():
        assert torch.equal(p, flat_p[name]), name
        assert torch.equal(ring_1[name], p), name
    port_ring = params_from_jax(init_params(
        TransformerConfig(**_cfg_kw("ring_flash", True)), 0))
    port_flat = params_from_jax(init_params(
        TransformerConfig(**_cfg_kw("flash", False)), 0))
    assert port_ring.keys() == ring_p.keys()
    for name, p in port_ring.items():
        assert torch.equal(p, port_flat[name]), name
        assert p.shape == ring_p[name].shape and p.dtype == ring_p[name].dtype


def test_ring_flash_forward_bf16_matches_reference():
    """The ring_flash forward at bf16 over sp 2 shards, on the
    reference's own init, against the reference's ring_flash forward
    under ``shard_map`` at bf16 and fp32 (its plain ticks): the port's
    logits no farther from the reference's fp32 logits than twice the
    reference's bf16 logits are, plus 1e-5, and no nearer than half as
    far."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from torch.func import functional_call

    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)
    from stochastic_gradient_push_tpu.train.lm import (
        SEQ_AXIS, make_dp_sp_mesh)

    sp = 2
    tokens = np.random.default_rng(41).integers(0, VOCAB, (B, T)).astype(
        np.int32)
    mesh = make_dp_sp_mesh(1, sp)
    logits, params = {}, None
    for dtype in ("float32", "bfloat16"):
        model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                            n_heads=H, d_ff=FF, max_len=T,
                            attn_impl="ring_flash", seq_axis=SEQ_AXIS,
                            dtype=getattr(jnp, dtype)))
        if params is None:
            params = jax.jit(jax.shard_map(
                lambda x: model.init(jax.random.PRNGKey(0), x)["params"],
                mesh=mesh, in_specs=P(None, SEQ_AXIS), out_specs=P(),
                check_vma=False))(tokens)
        logits[dtype] = np.asarray(jax.jit(jax.shard_map(
            lambda p, x: model.apply({"params": p}, x), mesh=mesh,
            in_specs=(P(), P(None, SEQ_AXIS)),
            out_specs=P(None, SEQ_AXIS)))(params, tokens))
    cfg = TransformerConfig(**_cfg_kw("ring_flash", False, "bfloat16"))
    shards = torch.from_numpy(tokens).long().reshape(B, sp, T // sp)
    got = functional_call(tlm.make_model(cfg), params_from_jax(params),
                          (shards.transpose(0, 1), StackedSeq(sp)))
    got = got.transpose(0, 1).reshape(B, T, VOCAB).numpy()
    ref32, ref16 = logits["float32"], logits["bfloat16"]
    ref_dist = np.abs(ref16 - ref32).max()
    assert ref_dist > 1e-3
    assert 0.5 * ref_dist <= np.abs(got - ref32).max() <= 2 * ref_dist + 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_sp_bf16_steps_match_reference(remat):
    """Three SGP steps at dp 2 x sp 2 with ring_flash at bf16 against the
    compiled reference at bf16, from one fp32 state: losses within
    ``BF16_LOSS_RTOL``, the push-sum weight exactly equal, params from
    the reference's fp32 run between half and twice its bf16 run's
    distance, plus 1e-5."""
    batches = _batches(2, 2, 51)
    start, want32, _ = _jax_run(2, 2, "ring_flash", remat, "sgp", batches)
    _, want, jm = _jax_run(2, 2, "ring_flash", remat, "sgp", batches,
                           dtype="bfloat16")
    got, tm = _port_run(2, 2, "ring_flash", remat, "sgp", start, batches,
                        dtype="bfloat16")
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"].numpy(),
                                   np.asarray(j["loss"]).reshape(-1),
                                   rtol=drive.BF16_LOSS_RTOL, atol=0)
    np.testing.assert_array_equal(
        got.gossip.ps_weight.numpy(),
        np.asarray(want.gossip.ps_weight, np.float32).reshape(-1))
    ref32, ref16 = (params_from_jax(w.params) for w in (want32, want))
    drive.assert_bf16_params(got.params, ref16, ref32)
    assert got.step == STEPS
