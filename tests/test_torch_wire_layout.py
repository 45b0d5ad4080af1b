"""Port parity: the int8 wire blocks each leaf in the reference's layout.

The port keeps conv kernels OIHW and Dense kernels ``[out, in]``; the
reference keeps them HWIO and ``[in, out]`` (``models/convert.py``).  The
int8 codec cuts a flattened leaf into 64-element blocks, each with its
own scale, so blocking the port's layout groups other elements than the
reference's and every scale differs.  The port hands the codec each leaf
through ``models/convert.py::reference_layout`` instead.

* ``reference_layout``: the port names in the reference's flatten order
  (JAX's sorted-key order) and each kernel's permutation, read off the
  converter itself (ResNet-18 with the CIFAR stem, the d64/L2 LM).
* One int8 SGP round at world 4 over converted ResNet-18 (CIFAR stem)
  and LM (d64/L2) params, on the reference (``jax.jit`` of its round
  under ``shard_map`` on the virtual CPU mesh) and on the port's plain
  lane: the mixed params, converted back, and the ps-weight are
  **bit-equal**.  The kernel lane (the K1/K2 plain twins, 3 buckets)
  keeps the ps-weight bit-equal and the params within one ulp: there
  the local share ``lo * x`` is rounded on its own before the wait adds
  the edges, where the reference's plain round fuses ``lo * x + recv``.
* The same round without the layout (the port's own blocking) is not
  bit-equal: the test above is what catches a regression of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.models.convert import (
    init_params, params_from_jax, reference_layout, vision_params_from_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig, TransformerLM)
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from stochastic_gradient_push_torch.train.step import make_model

torch.set_num_threads(2)

W = 4
LM_CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, d_ff=256)


def _resnet_tree():
    """Reference ResNet-18 (CIFAR stem) params, rank-stacked numpy."""
    from stochastic_gradient_push_tpu.models import resnet18

    shapes = jax.eval_shape(
        resnet18(num_classes=10, small_images=True).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: (rng.standard_normal((W,) + s.shape) * 0.1).astype(
            np.float32), shapes)


def _lm_tree():
    one = init_params(TransformerConfig(**LM_CFG), seed=0)
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (a[None] + rng.standard_normal((W,) + a.shape) * 0.02
                   ).astype(np.float32), one)


def _case(name):
    """(numpy flax tree [W, ...], port model, tree -> port params)."""
    if name == "resnet":
        model = make_model("resnet18", num_classes=10, small_images=True)
        return (_resnet_tree(), model,
                lambda t: vision_params_from_jax(model, {"params": t})[0])
    with torch.device("meta"):
        model = TransformerLM(TransformerConfig(**LM_CFG))
    return _lm_tree(), model, params_from_jax


def _reference_round(tree, ps):
    from stochastic_gradient_push_tpu import topology as rt
    from stochastic_gradient_push_tpu.parallel import wire as rw
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    sched = rt.build_schedule(rt.NPeerDynamicDirectedExponentialGraph(W))

    def body(p, w):
        return mix_push_sum(p, w, jnp.int32(0), sched, GOSSIP_AXIS,
                            codec=rw.Int8Codec(64))

    fn = jax.jit(jax.shard_map(
        body, mesh=make_gossip_mesh(W),
        in_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS)),
        out_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS))))
    return jax.device_get(fn(tree, ps))


def _port_round(params, ps, layout, kernel=None):
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(W))
    return tc.mix_push_sum(
        {n: p.clone() for n, p in params.items()}, torch.from_numpy(ps),
        0, sched, tc.StackedTransport(W), codec=tw.Int8Codec(64),
        kernel=kernel, buckets=3, layout=layout)


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.spacing(np.abs(b))))


@pytest.mark.parametrize("case", ["resnet", "lm"])
def test_layout_is_the_reference_order_and_layout(case):
    tree, model, convert = _case(case)
    layout = reference_layout(model)
    # leaf k of the reference's flatten order holds the value k
    leaves, treedef = jax.tree.flatten(tree)
    tagged = jax.tree.unflatten(treedef, [
        np.full_like(a, k) for k, a in enumerate(leaves)])
    port = convert(tagged)
    assert [float(port[n].reshape(-1)[0]) for n in layout.order] == \
        list(range(len(leaves)))
    # each permutation turns the port's tensor into the reference's
    ref = dict(zip(layout.order, leaves))
    port = convert(tree)
    for name, t in port.items():
        perm = layout.perm(name)
        view = t if perm is None else t.permute(0, *(d + 1 for d in perm))
        np.testing.assert_array_equal(view.numpy(), ref[name], err_msg=name)
    assert layout.perms, "no kernel is transposed"


@pytest.mark.parametrize("case", ["resnet", "lm"])
def test_int8_round_bit_equal_reference(case):
    tree, model, convert = _case(case)
    ps = (1.0 + np.random.default_rng(2).random(W)).astype(np.float32)
    ref_p, ref_w = _reference_round(tree, ps)
    want = convert(ref_p)
    params = convert(tree)
    layout = reference_layout(model)

    got, got_w = _port_round(params, ps, layout)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      want[name].numpy(), err_msg=name)

    # the kernel lane (plain twins, 3 buckets): ps-weight exact, params
    # within one ulp (the local share rounds on its own there)
    kgot, kgot_w = _port_round(params, ps, layout,
                               kernel=KernelLane(interpret=True))
    np.testing.assert_array_equal(kgot_w.numpy(), np.asarray(ref_w))
    for name in want:
        assert _ulps(kgot[name].numpy(), want[name].numpy()) <= 1.0, name

    # blocked in the port's own layout, the kernels' scales differ
    plain, _ = _port_round(params, ps, None)
    moved = [n for n in layout.perms
             if not torch.equal(plain[n], want[n])]
    assert moved, "the port's layout blocked like the reference's"
