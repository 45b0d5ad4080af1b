"""The wire codec's selftest on the port (``parallel/wirecheck.py``,
``scripts/torch_wirecheck.py``), on the CPU: the four stages pass in
process on the stacked lane at world 8 with the kernel lane's twins, the
script exits 0 printing ``wire selftest: OK``, a CUDA device without a
card is refused by name, stage 3's pricing equals the reference's for
the same template, and stage 1's chaos round run on the reference
(``jax.jit`` of its round under ``shard_map``) ends where the port's
does: ps-weight bit-equal, params within 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.parallel import wirecheck

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_selftest_passes_in_process(capsys):
    assert wirecheck.selftest("cpu") == 0
    out = capsys.readouterr().out
    assert out.startswith("wire selftest: OK (world 8 stacked on cpu")
    assert "ps-weight bit-identical" in out


def test_script_prints_ok_and_exits_0():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_wirecheck.py"),
         "--selftest", "--device", "cpu"], capture_output=True, text=True,
        timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "wire selftest: OK" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_kernel_lane_that_cannot_be_had_is_refused(capsys):
    assert wirecheck.selftest("cuda") == 1
    err = capsys.readouterr().err
    assert "the gossip kernel lane cannot be had on cuda" in err


def test_no_mode_is_a_usage_error():
    with pytest.raises(SystemExit) as e:
        wirecheck.main([])
    assert e.value.code == 2


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_stage3_pricing_equals_the_reference(codec):
    from stochastic_gradient_push_torch import telemetry as tt
    from stochastic_gradient_push_torch import topology as ttopo
    from stochastic_gradient_push_torch.parallel import wire as twire
    from stochastic_gradient_push_tpu import telemetry as rt
    from stochastic_gradient_push_tpu import topology as rtopo
    from stochastic_gradient_push_tpu.parallel import wire as rwire

    world = wirecheck.WORLD
    shapes = {"w": (world, 1000), "b": (world, 24)}
    port = tt.encoded_payload_bytes(
        {n: torch.zeros(s) for n, s in shapes.items()}, world,
        twire.get_codec(codec, 64))
    ref = rt.encoded_payload_bytes(
        {n: np.zeros(s, np.float32) for n, s in shapes.items()}, world,
        rwire.get_codec(codec, 64))
    assert port == ref
    models = [
        mod.CommModel.from_schedule(
            topo.build_schedule(
                topo.NPeerDynamicDirectedExponentialGraph(world)),
            enc, exact_bytes=4 * 1024, codec=wire.get_codec(codec, 64),
            error_feedback=True)
        for mod, topo, wire, enc in ((tt, ttopo, twire, port),
                                     (rt, rtopo, rwire, ref))]
    assert models[0].to_dict() == models[1].to_dict()
    assert models[0].totals(4) == models[1].totals(4)


def test_chaos_round_ends_where_the_reference_does():
    """Stage 1's loop (int8 + EF, the dropped edge, 12 rounds) on the
    port and on the reference's compiled round: ps-weight bit-equal
    every round, params and residual within 1e-6."""
    import jax
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_torch import algorithms as talg
    from stochastic_gradient_push_torch import topology as ttopo
    from stochastic_gradient_push_torch.parallel import wire as twire
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.resilience import (
        parse_fault_spec as tparse)
    from stochastic_gradient_push_tpu import algorithms as ralg
    from stochastic_gradient_push_tpu import topology as rtopo
    from stochastic_gradient_push_tpu.parallel import wire as rwire
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)
    from stochastic_gradient_push_tpu.resilience import (
        parse_fault_spec as rparse)

    world = wirecheck.WORLD
    if jax.device_count() < world:
        pytest.skip(f"the reference round needs {world} devices")
    x0 = np.random.default_rng(0).normal(size=(world, 128)).astype(
        np.float32)

    tsched = ttopo.build_schedule(ttopo.RingGraph(world))
    talgo = talg.sgp(tsched, StackedTransport(world),
                     faults=tparse(wirecheck.CHAOS_SPEC).build_masks(tsched),
                     wire=twire.Int8Codec(64), error_feedback=True)
    p = {"x": torch.from_numpy(x0.copy())}
    g = talgo.init(p)
    port = []
    for _ in range(wirecheck.CHAOS_ROUNDS):
        p, g = talgo.post_step(p, g)
        port.append((p["x"].numpy().copy(), g.ps_weight.numpy().copy(),
                     g.ef_residual["x"].numpy().copy()))

    rsched = rtopo.build_schedule(rtopo.RingGraph(world))
    ralgo = ralg.sgp(rsched, GOSSIP_AXIS,
                     faults=rparse(wirecheck.CHAOS_SPEC).build_masks(rsched),
                     wire=rwire.Int8Codec(64), error_feedback=True)
    step = jax.jit(jax.shard_map(
        ralgo.post_step, mesh=make_gossip_mesh(world),
        in_specs=(P(GOSSIP_AXIS),) * 2, out_specs=(P(GOSSIP_AXIS),) * 2))
    rp = x0.copy()
    rg = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a),
                                  (world,) + np.shape(a)).copy(),
        ralgo.init(np.zeros((128,), np.float32)))
    for t in range(wirecheck.CHAOS_ROUNDS):
        rp, rg = jax.block_until_ready(step(rp, rg))
        tp, tw, tres = port[t]
        np.testing.assert_array_equal(tw, np.asarray(rg.ps_weight))
        np.testing.assert_allclose(tp, np.asarray(rp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tres, np.asarray(rg.ef_residual),
                                   rtol=0, atol=1e-6)
