"""Port parity: ``parallel/seq.py``, ``parallel/ring_attention.py`` and
``ops/ring_flash.py`` (plain ticks) against the JAX package's
``ring_attention``, ``blockwise_attention`` and ``ring_flash_attention``,
run under ``jax.jit(jax.shard_map(...))`` on the 8-device CPU mesh.

The port holds a replica's sequence shards stacked, ``[sp, b, h, t, d]``;
the reference holds one shard per device.  The same numpy inputs go
through both: outputs and ``(dq, dk, dv)`` of ``Σ out·g`` for a random
cotangent ``g``, at sp 1, 2, 4 and 8, causal and not, within atol 1e-5
(fp32 sums in another order).  The reference's ``ring_flash`` runs with
its plain XLA tick (``use_pallas=False``) and through its Pallas kernels
in interpret mode (sp <= 4).  The tick owner/mode table is bit-equal to
the reference's ``_tick_mode`` for sp 1 to 8; the ring's direction is
the reference's ``ppermute`` ``i -> i+1``.

At bf16 (the reference's ``--precision bf16``) the same inputs, rounded
once to bf16, go through ``ring_flash``, ``ring`` and ``blockwise`` on
both sides at sp 2 and 4: outputs and gradients within two bf16 ulps for
the ring forms (each tick's output is rounded to bf16 once before the
fp32 merge, and each tick's gradients before the fp32 accumulators) and
one for ``blockwise`` (``tests/torch_bf16.py``), ``ring_flash``'s merged
lse within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops.lanes import KernelLaneError
from stochastic_gradient_push_torch.ops.ring_flash import (
    ring_flash_attention, ring_ticks)
from stochastic_gradient_push_torch.parallel.ring_attention import (
    blockwise_attention, ring_attention)
from stochastic_gradient_push_torch.parallel.seq import StackedSeq
from torch_bf16 import assert_bf16_close, from_jax

torch.set_num_threads(1)

B, H, T, D = 1, 2, 32, 16
ATOL = 1e-5


def _inputs(seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4)]


def _shard(x, sp):
    """[B, H, T, D] -> [sp, B, H, T/sp, D]: contiguous blocks."""
    return np.ascontiguousarray(np.moveaxis(
        x.reshape(B, H, sp, T // sp, D), 2, 0))


def _jax_ring(fn, sp, q, k, v, g, dtype=None):
    """Output and (dq, dk, dv) of ``Σ fn(q, k, v, "gossip")·g`` with one
    shard per device of an sp-device mesh (inputs cast to ``dtype``
    first, when given)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh

    def f(qb, kb, vb, gb):
        if dtype is not None:
            qb, kb, vb, gb = (x.astype(dtype) for x in (qb, kb, vb, gb))

        def loss(q, k, v):
            out = fn(q, k, v, "gossip")
            return jnp.sum(out * gb[0]), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(qb[0], kb[0],
                                                           vb[0])
        return (out[None],) + tuple(x[None] for x in grads)

    sharded = jax.jit(jax.shard_map(
        f, mesh=make_gossip_mesh(sp), in_specs=(P("gossip"),) * 4,
        out_specs=(P("gossip"),) * 4))
    out = sharded(*(_shard(a, sp) for a in (q, k, v, g)))
    return [np.asarray(x) if dtype is None else x for x in out]


def _port(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


def _close(got, want):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_ring_attention_matches_reference(sp, causal):
    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        ring_attention as jring)

    q, k, v, g = _inputs(sp + 10 * causal)
    want = _jax_ring(lambda q, k, v, ax: jring(q, k, v, ax, causal=causal),
                     sp, q, k, v, g)
    seq = StackedSeq(sp)
    got = _port(lambda q, k, v: ring_attention(q, k, v, seq, causal=causal),
                *(_shard(a, sp) for a in (q, k, v, g)))
    _close(got, want)


RING_FLASH_CASES = [(sp, causal, pallas) for sp in (1, 2, 4, 8)
                    for causal in (True, False) for pallas in (False, True)
                    if not (pallas and sp > 4)]


@pytest.mark.parametrize("sp,causal,pallas", RING_FLASH_CASES)
def test_ring_flash_plain_ticks_match_reference(sp, causal, pallas):
    """The port's plain ticks against the reference's plain tick
    (``pallas=False``) and against its Pallas kernels run by the
    interpreter (``pallas=True``)."""
    from stochastic_gradient_push_tpu.ops.ring_flash import (
        ring_flash_attention as jrf)

    q, k, v, g = _inputs(100 + sp + 10 * causal)
    want = _jax_ring(lambda q, k, v, ax: jrf(
        q, k, v, ax, causal=causal, interpret=pallas, use_pallas=pallas),
        sp, q, k, v, g)
    seq = StackedSeq(sp)
    got = _port(lambda q, k, v: ring_flash_attention(q, k, v, seq,
                                                     causal=causal),
                *(_shard(a, sp) for a in (q, k, v, g)))
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [4, 8, 32])
def test_blockwise_attention_matches_reference(block, causal):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        blockwise_attention as jblock)

    q, k, v, g = _inputs(200 + block + causal)

    def loss(q, k, v):
        out = jblock(q, k, v, block, causal=causal)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [np.asarray(x) for x in (out, *grads)]
    got = _port(lambda q, k, v: blockwise_attention(q, k, v, block,
                                                    causal=causal),
                q, k, v, g)
    _close(got, want)


@pytest.mark.parametrize("sp", range(1, 9))
def test_tick_table_is_the_references(sp):
    """Owner and mode of every (tick, shard), causal and not, against the
    reference's loop owners ``(r - s) % sp`` and after-loop owner ``(r +
    1) % sp``, each through its ``_tick_mode``."""
    from stochastic_gradient_push_tpu.ops.ring_flash import (
        _DIAG, _FULL, _SKIP, _tick_mode)

    assert (_FULL, _DIAG, _SKIP) == (0, 1, 2)
    for causal in (True, False):
        want = []
        for s in range(sp - 1):
            owners = [(r - s) % sp for r in range(sp)]
            want.append(owners)
        want.append([(r + 1) % sp if sp > 1 else r for r in range(sp)])
        table = ring_ticks(sp, causal)
        assert [[o for o, _ in tick] for tick in table] == want
        modes = [[int(_tick_mode(np.int32(r), np.int32(o), causal))
                  for r, o in enumerate(tick)] for tick in want]
        assert [[m for _, m in tick] for tick in table] == modes
    visible = sum(m != 2 for tick in ring_ticks(sp, True) for _, m in tick)
    assert visible == sp * (sp + 1) // 2


def test_ring_shift_is_the_references_ppermute():
    """``StackedSeq.ring_shift`` equals ``lax.ppermute(x, seq, [(i, (i +
    1) % sp)])`` (sp 3, where a ring shifted the wrong way shows)."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh

    sp = 3
    x = np.arange(sp * 4, dtype=np.float32).reshape(sp, 4)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    want = jax.jit(jax.shard_map(
        lambda a: lax.ppermute(a, "gossip", perm), mesh=make_gossip_mesh(sp),
        in_specs=P("gossip"), out_specs=P("gossip")))(x)
    got = StackedSeq(sp).ring_shift(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(StackedSeq(sp).index().numpy(), [0, 1, 2])


def test_forced_kernel_lane_on_cpu_raises():
    seq = StackedSeq(2)
    q = torch.zeros(2, 1, 1, 8, 64)
    with pytest.raises(KernelLaneError):
        ring_flash_attention(q, q, q, seq, causal=True, lane="kernel")
    with pytest.raises(ValueError, match="lane"):
        ring_flash_attention(q, q, q, seq, causal=True, lane="fast")
    with pytest.raises(ValueError, match="shape"):
        ring_flash_attention(q, q, q, StackedSeq(4), causal=True)


def _bf16_inputs(seed):
    """The fp32 inputs rounded once to bf16, as fp32 numpy (exact)."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for a in _inputs(seed)]


def _port_bf16(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
               for a in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(g).to(torch.bfloat16))
    return [x.detach() for x in (out, *grads)]


def _close_bf16(got, want, ulps):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert_bf16_close(a, from_jax(b), ulps=ulps, name=name)


BF16_RING_CASES = [(sp, causal) for sp in (2, 4) for causal in (True, False)]


@pytest.mark.parametrize("sp,causal", BF16_RING_CASES)
@pytest.mark.parametrize("pallas", [False, True])
def test_ring_flash_bf16_matches_reference(sp, causal, pallas):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.ops.ring_flash import (
        ring_flash_attention as jrf)

    q, k, v, g = _bf16_inputs(300 + sp + 10 * causal)
    want = _jax_ring(lambda q, k, v, ax: jrf(
        q, k, v, ax, causal=causal, interpret=pallas, use_pallas=pallas),
        sp, q, k, v, g, dtype=jnp.bfloat16)
    seq = StackedSeq(sp)
    got = _port_bf16(lambda q, k, v: ring_flash_attention(q, k, v, seq,
                                                          causal=causal),
                     *(_shard(a, sp) for a in (q, k, v, g)))
    assert all(x.dtype == torch.bfloat16 for x in got)
    _close_bf16(got, want, ulps=2)


@pytest.mark.parametrize("sp,causal", BF16_RING_CASES)
def test_ring_flash_bf16_lse_matches_reference(sp, causal):
    """The merged fp32 lse of the bf16 ring forward (the residual its
    backward reads) against the reference's ``_ring_forward``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_torch.ops.ring_flash import _ring_forward
    from stochastic_gradient_push_tpu.ops.ring_flash import (
        _ring_forward as jforward)
    from stochastic_gradient_push_tpu.parallel import make_gossip_mesh

    q, k, v, _ = (_shard(a, sp) for a in _bf16_inputs(400 + sp + causal))

    def f(qb, kb, vb):
        out, lse = jforward(*(x[0].astype(jnp.bfloat16) for x in (qb, kb,
                                                                   vb)),
                            "gossip", causal, False, False, T // sp)
        return out[None], lse[None]

    out, lse = jax.jit(jax.shard_map(
        f, mesh=make_gossip_mesh(sp), in_specs=(P("gossip"),) * 3,
        out_specs=(P("gossip"),) * 2))(q, k, v)
    got_out, got_lse = _ring_forward(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        StackedSeq(sp), causal, False)
    assert got_lse.dtype == torch.float32
    assert_bf16_close(got_out, from_jax(out), ulps=2, name="out")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("sp,causal", BF16_RING_CASES)
def test_ring_attention_bf16_matches_reference(sp, causal):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        ring_attention as jring)

    q, k, v, g = _bf16_inputs(500 + sp + 10 * causal)
    want = _jax_ring(lambda q, k, v, ax: jring(q, k, v, ax, causal=causal),
                     sp, q, k, v, g, dtype=jnp.bfloat16)
    seq = StackedSeq(sp)
    got = _port_bf16(lambda q, k, v: ring_attention(q, k, v, seq,
                                                    causal=causal),
                     *(_shard(a, sp) for a in (q, k, v, g)))
    _close_bf16(got, want, ulps=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [8, 32])
def test_blockwise_attention_bf16_matches_reference(block, causal):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        blockwise_attention as jblock)

    q, k, v, g = _bf16_inputs(600 + block + causal)

    def loss(q, k, v, g):
        q, k, v, g = (x.astype(jnp.bfloat16) for x in (q, k, v, g))

        def inner(q, k, v):
            out = jblock(q, k, v, block, causal=causal)
            return jnp.sum(out * g), out

        (_, out), grads = jax.value_and_grad(inner, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
        return (out, *grads)

    want = jax.jit(loss)(q, k, v, g)
    got = _port_bf16(lambda q, k, v: blockwise_attention(q, k, v, block,
                                                         causal=causal),
                     q, k, v, g)
    _close_bf16(got, want, ulps=1)
