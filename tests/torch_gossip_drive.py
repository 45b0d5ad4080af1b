"""Shared harness of the resilience parity tests: the reference's and the
port's push-sum algorithm slots stepped side by side from one numpy
state at world 4.

One step is ``pre_step``, then ``params - (eval_params - target)`` (no
multiply, so XLA has nothing to fuse and both frameworks round alike),
then ``post_step``: the reference's compiled under ``shard_map`` on the
virtual CPU mesh, the port's on rank-stacked CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from stochastic_gradient_push_torch.resilience import faults as tfaults

WORLD = 4
SHAPES = {"w": (6, 50), "b": (130,), "s": (1,)}
BLOCK = 16


def mixing(mod, kind, world=WORLD):
    if kind == "self":
        return mod.SelfWeightedMixing(np.linspace(0.3, 0.7, world))
    return mod.UniformMixing()


def schedules(ppi=1, mix="uniform", world=WORLD):
    """The reference's and the port's schedule of one graph."""
    from stochastic_gradient_push_tpu import topology as rt

    graph = "NPeerDynamicDirectedExponentialGraph"
    return tuple(mod.build_schedule(
        getattr(mod, graph)(world, peers_per_itr=ppi),
        mixing(mod, mix, world)) for mod in (rt, tt))


def codecs(wire):
    from stochastic_gradient_push_tpu.parallel import wire as rw

    if wire in (None, "none"):
        return None, None
    return rw.get_codec(wire, BLOCK), tw.get_codec(wire, BLOCK)


def masks(spec, jsched, tsched, gossip_every=1, reabsorb=True):
    from stochastic_gradient_push_tpu.resilience import faults as rfaults

    if spec is None:
        return None, None
    return (rfaults.parse_fault_spec(spec).build_masks(
                jsched, reabsorb=reabsorb, gossip_every=gossip_every),
            tfaults.parse_fault_spec(spec).build_masks(
                tsched, reabsorb=reabsorb, gossip_every=gossip_every))


def data(seed, steps):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal((WORLD,) + s).astype(np.float32)
              for n, s in SHAPES.items()}
    targets = [{n: rng.standard_normal((WORLD,) + s).astype(np.float32)
                for n, s in SHAPES.items()} for _ in range(steps)]
    return params, targets


def algorithms(overlap=False, staleness=1, gossip_every=1, wire=None,
               error_feedback=False, spec=None, ppi=1, mix="uniform",
               kernel=None, buckets=1):
    """(reference algorithm, port algorithm) of one configuration."""
    from stochastic_gradient_push_tpu.algorithms import sgp as rsgp
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    jsched, tsched = schedules(ppi, mix)
    jcodec, tcodec = codecs(wire)
    jm, tm = masks(spec, jsched, tsched, gossip_every)
    ref = rsgp(jsched, GOSSIP_AXIS, overlap=overlap, staleness=staleness,
               gossip_every=gossip_every, wire=jcodec,
               error_feedback=error_feedback, faults=jm)
    port = talg.sgp(tsched, tc.StackedTransport(WORLD), overlap=overlap,
                    staleness=staleness, gossip_every=gossip_every,
                    wire=tcodec, error_feedback=error_feedback, faults=tm,
                    gossip_kernel=kernel, gossip_buckets=buckets)
    return ref, port


def _np_state(g):
    """A reference GossipState's rank-stacked leaves as numpy."""
    fifo = [({n: np.asarray(a) for n, a in p.items()},
             np.asarray(w).reshape(WORLD)) for p, w in g.in_flight or ()]
    res = (None if g.ef_residual is None
           else {n: np.asarray(a) for n, a in g.ef_residual.items()})
    return np.asarray(g.ps_weight).reshape(WORLD), fifo, res


def reference_trajectory(alg, params, targets):
    """Per step ``(params, ps_weight, fifo, residual)`` as numpy."""
    from stochastic_gradient_push_tpu.parallel import (
        GOSSIP_AXIS, make_gossip_mesh)

    def step(p, g, t):
        p, g = alg.pre_step(p, g)
        z = alg.eval_params(p, g)
        p = jax.tree.map(lambda a, b, c: a - (b - c), p, z, t)
        return alg.post_step(p, g)

    f = jax.jit(jax.shard_map(
        step, mesh=make_gossip_mesh(WORLD), in_specs=(P(GOSSIP_AXIS),) * 3,
        out_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS))))
    gstate = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a),
                                  (WORLD,) + np.shape(a)).copy(),
        alg.init({n: jnp.zeros(s, jnp.float32) for n, s in SHAPES.items()}))
    out = []
    for t in targets:
        params, gstate = jax.block_until_ready(f(params, gstate, t))
        params = {n: np.asarray(a) for n, a in params.items()}
        out.append((params, *_np_state(gstate)))
    return out


def port_trajectory(alg, params, targets):
    """The port's steps from the same numpy state, as numpy."""
    p = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    g = alg.init(p)
    out = []
    for t in targets:
        p, g = alg.pre_step(p, g)
        z = alg.eval_params(p, g)
        p = {n: a - (z[n] - torch.from_numpy(t[n])) for n, a in p.items()}
        p, g = alg.post_step(p, g)
        fifo = [({n: a.numpy() for n, a in fp.items()}, fw.numpy())
                for fp, fw in g.in_flight]
        res = (None if g.ef_residual is None
               else {n: a.numpy() for n, a in g.ef_residual.items()})
        out.append(({n: a.numpy() for n, a in p.items()},
                    g.ps_weight.numpy(), fifo, res))
    return out


def assert_within_input_ulp(got, want, inputs, what, ulps=4):
    """``|got - want|`` at most ``ulps`` ulps of the largest input
    magnitude (NaN positions must agree): the same terms of the inputs'
    scale summed in another order (each of the up to four roundings of
    a two-edge faulted round placed elsewhere)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    m = ~np.isnan(want)
    bound = ulps * np.spacing(np.float32(np.nanmax(np.abs(inputs))))
    assert np.all(np.abs(got[m] - want[m]) <= bound), (
        f"{what}: max |diff| {np.abs(got[m] - want[m]).max()} > {bound}")


def assert_equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def ref_flat_round(jsched, world, phase, codec=None, ef=False):
    """The reference's compiled flat push-sum round at ``phase`` over a
    ``world``-rank mesh: ``(params, ps_weight[, residual]) -> ...``."""
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    def body(p, w, *r):
        return mix_push_sum(p, w, jnp.int32(phase), jsched, GOSSIP_AXIS,
                            codec=codec, ef_residual=r[0] if r else None)

    n = 3 if ef else 2
    return jax.jit(jax.shard_map(
        body, mesh=make_gossip_mesh(world), in_specs=(P(GOSSIP_AXIS),) * n,
        out_specs=(P(GOSSIP_AXIS),) * n))


def np_group_mean(a, groups):
    """The reference's grouped psum ``lax.psum(a * float32(1/s),
    axis_index_groups=groups)`` as its numpy definition: the scaled rows
    of each group summed in rank order."""
    a = np.asarray(a, np.float32)
    sc = a * np.float32(1.0 / len(groups[0]))
    out = np.empty_like(a)
    for g in groups:
        acc = sc[g[0]]
        for r in g[1:]:
            acc = acc + sc[r]
        for r in g:
            out[r] = acc
    return out
