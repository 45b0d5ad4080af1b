"""Port parity: the LM training step (``stochastic_gradient_push_torch.
train.lm``) against the JAX package's ``build_lm_train_step`` +
``shard_lm_train_step`` on its CPU mesh, from one state and on the same
numpy token batches, with ``attn_impl="flash"`` on both sides (the JAX
side reaches its blockwise path on the CPU; the port its flash
``autograd.Function`` with the plain forward and backward).

Both start from the reference's own flax init, carried across by
``models/convert.py::train_state_from_jax``.  Three steps at dp 1 and
dp 4, SGP and AllReduce.  Tolerances: per-step losses within 1e-5
relative and grad norms within 1e-4 relative (fp32 sums in another
order); params and momentum after three steps within atol 2e-6; the
push-sum weight and the phase exactly equal.

OSGP momentum: after three steps both frameworks sit 1.48-1.71e-6 from
an fp64 run of the same step (the embedding rows many tokens hit, where
the momentum reaches 1.5), so the two can be ~2.3e-6 apart, over the
2e-6 of the other leaves.  The OSGP tests hold momentum to
``MOM_ATOL`` (4e-6, twice the larger distance) and the port's distance
from an fp64 run of its own step (``dtype=torch.float64``, ``full``
attention) to at most twice the reference's, plus 1e-7.

bf16 (the reference's ``--precision bf16``).  Module by module, on the
same bf16 inputs, the port's Embed, Dense (with and without bias),
LayerNorm and attention sublayer (full, flash) equal the reference's
flax modules to a bf16 ulp (LayerNorm's fp32 output to 1e-6): the casts
are the reference's.  Whole models drift apart: XLA lets a fused op skip
a bf16 rounding (on the CPU the residual sum enters LayerNorm unrounded)
and rounds jax's GELU op by op with bf16 constants, where the port
rounds each sum and takes PyTorch's GELU; from the first block's MLP on,
each one-ulp flip moves later roundings, so the two frameworks' bf16
logits sit 0.84 of the reference's bf16-to-fp32 distance apart (max
norm; 0.85 in L2), and the params after three steps 0.70-0.94.  So the
forward's logits at bf16 are held from both sides of the reference's
bf16-to-fp32 distance ``R``: no farther from the reference's fp32
logits than ``2 R`` plus 1e-5, and no nearer than ``R / 2`` (a port that
ran fp32 would sit ~1e-6 from them; the port sits 1.06 R).  Three SGP
steps at dp 2 at bf16: losses within ``BF16_LOSS_RTOL`` (2e-3) relative
of the reference's bf16 losses (bf16 logits round at 2**-9 relative;
the frameworks' bf16 runs sit 3.6e-4 apart, each up to 6.2e-4 from the
fp32 run), the push-sum weight exactly equal (the round is fp32), params
from the reference's fp32 run between half and twice the reference's
bf16 run's distance, plus 1e-5 (the port: 1.03).
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.models.convert import (
    params_from_jax, train_state_from_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)
from stochastic_gradient_push_torch.train import lm as tlm
from stochastic_gradient_push_torch.train.lr import LRSchedule
from stochastic_gradient_push_torch.train.state import sgd
import torch_lm_drive as drive
from torch_bf16 import assert_bf16_close, from_jax, jax_bf16, to_bf16

torch.set_num_threads(1)

VOCAB, D, L, H, FF, T, B = 64, 64, 2, 2, 128, 32, 2
STEPS = 3
LOSS_RTOL, GN_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-6
BF16_LOSS_RTOL = drive.BF16_LOSS_RTOL


def _jax_run(dp, alg_name, batches, seed=0, dtype="float32"):
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
        build_lm_train_step, init_lm_state, shard_lm_train_step)

    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                        n_heads=H, d_ff=FF, max_len=T, attn_impl="flash",
                        dtype=getattr(jnp, dtype)))
    mesh = make_gossip_mesh(dp)
    if alg_name == "sgp":
        alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=1)), GOSSIP_AXIS)
    elif alg_name == "osgp":
        alg = jalg.sgp(jbuild(JGraph(dp, peers_per_itr=2)), GOSSIP_AXIS,
                       overlap=True, staleness=2)
    else:
        alg = jalg.all_reduce(GOSSIP_AXIS)
    tx = jsgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lrs = JLR(ref_lr=0.5, batch_size=B, world_size=dp, decay_schedule={},
              warmup=True)
    step = shard_lm_train_step(
        build_lm_train_step(model, alg, tx, lrs, itr_per_epoch=2,
                            seq_axis=None), mesh, seq_axis=None)
    state = init_lm_state(model, mesh, alg, tx, dp=dp, sp=1, batch_size=B,
                          block_len=T, seed=seed, seq_axis=None)
    start = jax.device_get(state)
    metrics = []
    for toks, tgts in batches:
        state, m = step(state, toks, tgts)
        metrics.append(jax.device_get(m))
    return start, jax.device_get(state), metrics


def _port_run(dp, alg_name, start, batches, gossip_kernel=None,
              gossip_buckets=1, dtype="float32", attn_impl="flash"):
    transport = StackedTransport(dp)
    if alg_name == "sgp":
        alg = talg.sgp(build_schedule(
            NPeerDynamicDirectedExponentialGraph(dp, peers_per_itr=1)),
            transport)
    elif alg_name == "osgp":
        alg = talg.osgp(build_schedule(
            NPeerDynamicDirectedExponentialGraph(dp, peers_per_itr=2)),
            transport, staleness=2, gossip_kernel=gossip_kernel,
            gossip_buckets=gossip_buckets)
    else:
        alg = talg.all_reduce(transport)
    cfg = TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                            n_heads=H, d_ff=FF, attn_impl=attn_impl,
                            dtype=getattr(torch, dtype))
    step = tlm.build_lm_train_step(
        tlm.make_model(cfg), alg, sgd(0.9, 1e-4, nesterov=True),
        LRSchedule(0.5, B, dp, decay_schedule={}, warmup=True),
        itr_per_epoch=2)
    state = train_state_from_jax(start)
    if dtype == "float64":
        state = drive.fp64_state(state)
    metrics = []
    for toks, tgts in batches:
        state, m = step(state, torch.from_numpy(toks).long(),
                        torch.from_numpy(tgts).long())
        metrics.append(m)
    return state, metrics


def _batches(dp, seed):
    r = np.random.default_rng(seed)
    return [tuple(r.integers(0, VOCAB, size=(dp, B, T)).astype(np.int32)
                  for _ in range(2)) for _ in range(STEPS)]


@pytest.mark.parametrize("dp", [1, 4])
@pytest.mark.parametrize("alg_name", ["sgp", "ar"])
def test_lm_step_matches_reference(dp, alg_name):
    batches = _batches(dp, 10 * dp + len(alg_name))
    start, want, jm = _jax_run(dp, alg_name, batches)
    got, tm = _port_run(dp, alg_name, start, batches)

    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"].numpy(), np.asarray(j["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["ppl"].numpy(), np.asarray(j["ppl"]),
                                   rtol=2 * LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["grad_norm"].numpy(),
                                   np.asarray(j["grad_norm"]),
                                   rtol=GN_RTOL, atol=0)
        assert np.float32(t["lr"]) == np.asarray(j["lr"]).reshape(-1)[0]
    for name, w in params_from_jax(want.params).items():
        np.testing.assert_allclose(got.params[name].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    trace = [s.trace for s in want.opt_state if hasattr(s, "trace")][0]
    for name, w in params_from_jax(trace).items():
        np.testing.assert_allclose(got.opt_state[name].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_array_equal(
        got.gossip.ps_weight.numpy(),
        np.asarray(want.gossip.ps_weight, np.float32).reshape(-1))
    assert got.gossip.phase == int(np.asarray(want.gossip.phase)[0])
    assert got.step == int(np.asarray(want.step)[0]) == STEPS


@pytest.mark.parametrize("lane", ["kernel", "plain"])
def test_lm_osgp_steps_match_reference(lane):
    """OSGP at dp 4 (staleness 2, two peers, the exact wire) for three
    steps from the reference's own start state, on the port's kernel
    lane (plain twins, three transport buckets) or its plain lane:
    losses within 1e-5 relative, the push-sum weight and the in-flight
    FIFO's weights exactly equal, params and the FIFO's params within
    atol, momentum within ``MOM_ATOL`` and no farther from an fp64 run
    than twice the reference's.  (A lossy wire would turn the
    frameworks' ~1e-7 differences in summation order into whole
    bf16/int8 steps of a few elements; the wires are held bit for bit in
    tests/test_torch_gossip_kernel.py.)"""
    dp = 4
    batches = _batches(dp, 77)
    start, want, jm = _jax_run(dp, "osgp", batches)
    kernel = KernelLane(interpret=True, chunk_elems=4096) \
        if lane == "kernel" else None
    got, tm = _port_run(dp, "osgp", start, batches, gossip_kernel=kernel,
                        gossip_buckets=3)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"].numpy(), np.asarray(j["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
    np.testing.assert_array_equal(
        got.gossip.ps_weight.numpy(),
        np.asarray(want.gossip.ps_weight, np.float32).reshape(-1))
    for name, w in params_from_jax(want.params).items():
        np.testing.assert_allclose(got.params[name].numpy(), w.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    assert len(got.gossip.in_flight) == len(want.gossip.in_flight) == 2
    for (gp, gw), (wp, ww) in zip(got.gossip.in_flight,
                                  want.gossip.in_flight):
        np.testing.assert_array_equal(gw.numpy(), np.asarray(
            ww, np.float32).reshape(-1))
        for name, w in params_from_jax(wp).items():
            np.testing.assert_allclose(gp[name].numpy(), w.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    assert got.gossip.phase == int(np.asarray(want.gossip.phase)[0]) == STEPS
    trace = params_from_jax([s.trace for s in want.opt_state
                             if hasattr(s, "trace")][0])
    exact, _ = _port_run(dp, "osgp", start, batches, dtype="float64",
                         attn_impl="full")
    drive.assert_momentum(got.opt_state, trace, exact.opt_state)


def _jax_forward(impl, dtype, tokens, params=None, seed=0):
    """The reference's logits (fp32) for ``tokens`` [B, T] at ``dtype``,
    and its params (its own init from ``seed`` when not given)."""
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, TransformerLM as JLM)

    model = JLM(JConfig(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                        d_ff=FF, max_len=T, attn_impl=impl,
                        dtype=getattr(jnp, dtype)))
    if params is None:
        params = model.init(jax.random.PRNGKey(seed), tokens)["params"]
    logits = jax.jit(lambda p, x: model.apply({"params": p}, x))(params,
                                                                 tokens)
    return np.asarray(logits), params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    """Rotary embeddings at each compute type: fp32 angles, the rotation
    in fp32 (bf16 inputs promoted), rounded back to the input type; the
    port's ``rope`` equals the reference's ``_rope`` or sits one ulp of
    the type from it (``sin``/``cos`` of the two frameworks)."""
    import jax.numpy as jnp

    from stochastic_gradient_push_torch.models.transformer import rope
    from stochastic_gradient_push_tpu.models.transformer import _rope
    from torch_bf16 import assert_bf16_close

    x = np.random.default_rng(8).standard_normal((2, 3, 40, 16)).astype(
        np.float32)
    pos = np.arange(100, 140)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _rope(jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype)),
                 jnp.asarray(pos))
    got = rope(xt, torch.from_numpy(pos))
    assert got.dtype == xt.dtype and str(want.dtype) == dtype
    if dtype == "bfloat16":
        assert_bf16_close(got, torch.from_numpy(np.array(
            want, np.float32)).to(torch.bfloat16), name="rope")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_lm_forward_bf16_matches_reference(impl):
    """The port's bf16 forward (``dtype=torch.bfloat16``) on the
    reference's own init, held to the reference's distance between its
    bf16 and fp32 logits."""
    from torch.func import functional_call

    tokens = np.random.default_rng(40).integers(0, VOCAB, (B, T)).astype(
        np.int32)
    ref32, params = _jax_forward(impl, "float32", tokens)
    ref16, _ = _jax_forward(impl, "bfloat16", tokens, params)
    cfg = TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                            n_heads=H, d_ff=FF, attn_impl=impl,
                            dtype=torch.bfloat16)
    got = functional_call(tlm.make_model(cfg), params_from_jax(params),
                          (torch.from_numpy(tokens).long(),))
    assert got.dtype == torch.float32
    got = got.numpy()
    ref_dist = np.abs(ref16 - ref32).max()
    assert ref_dist > 1e-3          # bf16 really ran on both sides
    assert np.abs(got - ref32).max() <= 2 * ref_dist + 1e-5
    assert np.abs(got - ref32).max() >= 0.5 * ref_dist
    assert np.abs(got - ref16).max() <= 2 * ref_dist + 1e-5


def _bf16_module_pair(kind, impl, rng):
    """A flax module of the reference at bf16 compute, its params, the
    port's module carrying the same params, and a bf16 input for both."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_torch.models import transformer as tt
    from stochastic_gradient_push_tpu.models.transformer import (
        TransformerConfig as JConfig, _Attention)

    bf = jnp.bfloat16
    if kind == "embed":
        x = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
        ref = fnn.Embed(VOCAB, D, dtype=bf,
                        embedding_init=fnn.initializers.normal(0.5))
        port = tt.Embed(VOCAB, D, compute=torch.bfloat16)
    else:
        x = to_bf16(rng.standard_normal((B, T, D)).astype(np.float32))
        if kind in ("dense", "dense_nobias"):
            ref = fnn.Dense(FF, use_bias=kind == "dense", dtype=bf,
                            bias_init=fnn.initializers.normal(0.5))
            port = tt.Dense(D, FF, bias=kind == "dense",
                            compute=torch.bfloat16)
        elif kind == "layernorm":
            ref = fnn.LayerNorm(dtype=jnp.float32,
                                scale_init=fnn.initializers.normal(1.0),
                                bias_init=fnn.initializers.normal(0.5))
            port = tt.LayerNorm(D)
        else:
            cfg = dict(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H,
                       d_ff=FF)
            ref = _Attention(JConfig(**cfg, max_len=T, attn_impl=impl,
                                     dtype=bf))
            port = tt.Attention(TransformerConfig(**cfg, attn_impl=impl,
                                                  dtype=torch.bfloat16))
    jx = jnp.asarray(x) if kind == "embed" else jax_bf16(x)
    args = (jx, jnp.arange(T)) if kind == "attention" else (jx,)
    params = ref.init(jax.random.PRNGKey(3), *args)["params"]
    return ref, params, port, x, args


@pytest.mark.parametrize("kind,impl", [
    ("embed", None), ("dense", None), ("dense_nobias", None),
    ("layernorm", None), ("attention", "full"), ("attention", "flash")])
def test_bf16_modules_match_reference(kind, impl):
    """The reference's bf16 casts, module by module on one bf16 input:
    Embed gathers from the table cast to bf16, Dense multiplies (and adds
    its bias) in bf16 on the fp32 kernel cast, LayerNorm widens and
    returns fp32, attention runs its q/k/v/o projections in bf16 and its
    softmax in fp32.  bf16 outputs equal the reference's or sit one ulp
    apart (sums in another order); LayerNorm's within 1e-6."""
    from torch.func import functional_call

    ref, params, port, x, args = _bf16_module_pair(
        kind, impl, np.random.default_rng(50))
    want = ref.apply({"params": params}, *args)
    tree = {"/".join(k): v for k, v in _flat(params)}
    state = {}
    for name, value in tree.items():
        t = torch.from_numpy(np.asarray(value, np.float32).copy())
        leaf = name.split("/")[-1]
        mod = name.rsplit("/", 1)[0].replace("/", ".") + "." if "/" in name \
            else ""
        if leaf == "kernel":
            state[mod + "weight"] = t.T.contiguous()
        elif leaf == "embedding" or leaf == "scale":
            state[mod + "weight"] = t
        else:
            state[mod + "bias"] = t
    pos = torch.arange(T)
    got = functional_call(port, state, (
        torch.from_numpy(x).long(),) if kind == "embed" else (
        (x, pos) if kind == "attention" else (x,)))
    if kind == "layernorm":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    else:
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        assert_bf16_close(got, from_jax(want), name=kind)


def _flat(tree, pre=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, pre + (k,))
        else:
            yield pre + (k,), v


def test_lm_bf16_steps_match_reference():
    """Three SGP steps at dp 2 at bf16 against the compiled reference at
    bf16 (flash attention: the reference's blockwise path on the CPU, the
    port's plain twins), from one fp32 state."""
    dp = 2
    batches = _batches(dp, 21)
    start, want32, _ = _jax_run(dp, "sgp", batches)
    _, want, jm = _jax_run(dp, "sgp", batches, dtype="bfloat16")
    got, tm = _port_run(dp, "sgp", start, batches, dtype="bfloat16")
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"].numpy(), np.asarray(j["loss"]),
                                   rtol=BF16_LOSS_RTOL, atol=0)
    np.testing.assert_array_equal(
        got.gossip.ps_weight.numpy(),
        np.asarray(want.gossip.ps_weight, np.float32).reshape(-1))
    assert all(p.dtype == torch.float32 for p in got.params.values())
    assert all(m.dtype == torch.float32 for m in got.opt_state.values())
    ref32, ref16 = (params_from_jax(w.params) for w in (want32, want))
    drive.assert_bf16_params(got.params, ref16, ref32)
    assert got.step == STEPS


def test_drain_state_folds_the_fifo_exactly_once():
    """The checkpoint view: every in-flight share added into the params
    once, the FIFO left as zero slots, total push-sum mass unchanged."""
    dp = 4
    batches = _batches(dp, 78)
    start, _, _ = _jax_run(dp, "osgp", batches[:1])
    got, _ = _port_run(dp, "osgp", start, batches[:2])
    drained = talg.drain_state(got)
    mass = float(got.gossip.ps_weight.sum()) + sum(
        float(w.sum()) for _, w in got.gossip.in_flight)
    np.testing.assert_allclose(float(drained.gossip.ps_weight.sum()), mass,
                               rtol=1e-6)
    for p, w in drained.gossip.in_flight:
        assert not w.any() and not any(t.any() for t in p.values())
    for name, p in got.params.items():
        want = p + sum(s[name] for s, _ in got.gossip.in_flight)
        torch.testing.assert_close(drained.params[name], want, rtol=0,
                                   atol=1e-6)
    assert talg.drain_state(drained).params is not got.params


def test_flash_and_full_lanes_give_one_step():
    """The model's two attention lanes agree through a whole step."""
    batches = _batches(2, 3)
    cfgs = [TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                              n_heads=H, d_ff=FF, attn_impl=impl)
            for impl in ("flash", "full")]
    out = []
    for cfg in cfgs:
        transport = StackedTransport(2)
        alg = talg.sgp(build_schedule(
            NPeerDynamicDirectedExponentialGraph(2)), transport)
        tx = sgd(0.9, 0.0)
        step = tlm.build_lm_train_step(tlm.make_model(cfg), alg, tx,
                                       LRSchedule(0.5, B, 2, {}), 10)
        state = tlm.init_lm_state(cfg, alg, tx, 2, seed=5)
        toks, tgts = (torch.from_numpy(a).long() for a in batches[0])
        out.append(step(state, toks, tgts))
    (s1, m1), (s2, m2) = out
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=1e-6, atol=0)
    for name in s1.params:
        torch.testing.assert_close(s1.params[name], s2.params[name],
                                   rtol=0, atol=1e-6)


def test_grad_accum_matches_full_batch():
    """Two microbatches give the full batch's step (the LM has no
    BatchNorm), within fp32 summation order."""
    cfg = TransformerConfig(vocab_size=VOCAB, d_model=D, n_layers=L,
                            n_heads=H, d_ff=FF, attn_impl="flash")
    toks, tgts = (torch.from_numpy(a).long() for a in _batches(1, 4)[0])
    res = []
    for accum in (1, 2):
        alg = talg.all_reduce(StackedTransport(1))
        tx = sgd(0.9, 0.0)
        step = tlm.build_lm_train_step(tlm.make_model(cfg), alg, tx,
                                       LRSchedule(0.5, B, 1, {}), 10,
                                       grad_accum=accum)
        res.append(step(tlm.init_lm_state(cfg, alg, tx, 1, seed=1),
                        toks, tgts))
    (s1, m1), (s2, m2) = res
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=1e-6, atol=0)
    for name in s1.params:
        torch.testing.assert_close(s1.params[name], s2.params[name],
                                   rtol=0, atol=1e-6)


def test_unported_attention_and_algorithm_options_raise():
    # every attention of the reference is ported; another name, a block
    # for the kernels' own tiles, or a forced lane off the kernels'
    # attentions (flash, ring_flash) is not
    with pytest.raises(ValueError, match="attn_impl 'paged'"):
        TransformerConfig(attn_impl="paged")
    with pytest.raises(ValueError, match="blockwise"):
        TransformerConfig(attn_impl="flash", attn_block_size=64)
    with pytest.raises(ValueError, match="ring_flash"):
        TransformerConfig(attn_impl="full", attn_lane="kernel")
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(2))

    class OneRankPerProcess:   # not the stacked transport
        world_size, ranks = 2, np.array([0])

    # fault injection and error feedback are ported: masks for another
    # thinning, and error feedback without a lossy wire, are refused
    from stochastic_gradient_push_torch.resilience import parse_fault_spec

    masks = parse_fault_spec("drop:0->1@0:4").build_masks(sched)
    assert talg.sgp(sched, StackedTransport(2), faults=masks).faults is masks
    for kwargs, name in (({"faults": masks, "gossip_every": 2},
                          "gossip_every=2"),
                         ({"error_feedback": True}, "lossy wire codec")):
        with pytest.raises(ValueError, match=name):
            talg.sgp(sched, StackedTransport(2), **kwargs)
    with pytest.raises(NotImplementedError, match="cross-process"):
        talg.sgp(sched, OneRankPerProcess(),
                 gossip_kernel=KernelLane(interpret=True))
