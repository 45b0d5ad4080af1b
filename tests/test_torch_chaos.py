"""The chaos drill on the port (``resilience/chaos.py``,
``scripts/torch_chaos.py``), held to the reference's.

* The drill on the CPU against ``jax.jit`` of the reference's drill
  (``stochastic_gradient_push_tpu/resilience/chaos.py``'s compiled
  ``shard_map`` round on a world-8 CPU mesh, the same spec, seed and
  rounds): the params and push-sum weights are bit-equal after the 12
  faulted rounds and after recovery and the one more round (the
  average's sum over the 8 ranks, ``x.sum(0)`` here and XLA's all-reduce
  there, adds them in the same order on the CPU).
* The kernel lane's twins (``KernelLane(interpret=True)``: the plain
  versions of the CUDA K2/K1) give the plain lane's bits, as the card's
  kernels do (``chip_smoke.py`` phase 27a).
* ``--describe`` prints the reference's lines, character for character.
* ``scripts/torch_chaos.py --selftest --device cpu`` exits 0; a forced
  kernel lane off CUDA raises ``KernelBackendError`` (the CLI: exit 1,
  naming it), and so does the default device where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.device import DeviceUnavailableError
from stochastic_gradient_push_torch.ops.gossip_kernel import (
    KernelBackendError, KernelLane)
from stochastic_gradient_push_torch.resilience import chaos as tchaos

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_drill():
    """The reference's drill (its ``_selftest``), statement for
    statement, returning the params and ps-weight after the faulted
    rounds and after recovery plus the one more round."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu.algorithms import sgp
    from stochastic_gradient_push_tpu.parallel import (GOSSIP_AXIS,
                                                       make_gossip_mesh)
    from stochastic_gradient_push_tpu.resilience import parse_fault_spec
    from stochastic_gradient_push_tpu.resilience.chaos import (
        SELFTEST_ROUNDS, SELFTEST_SPEC, WORLD)
    from stochastic_gradient_push_tpu.resilience.monitor import (
        health_signals)
    from stochastic_gradient_push_tpu.resilience.recovery import (
        make_recovery_fn)
    from stochastic_gradient_push_tpu.topology import (RingGraph,
                                                       build_schedule)

    sched = build_schedule(RingGraph(WORLD, peers_per_itr=1))
    masks = parse_fault_spec(SELFTEST_SPEC).build_masks(sched)
    alg = sgp(sched, GOSSIP_AXIS, faults=masks)
    mesh = make_gossip_mesh(WORLD)

    def gossip_step(params, gstate):
        params, gstate = alg.post_step(params, gstate)
        sig = health_signals(params, None, gstate.ps_weight, GOSSIP_AXIS)
        return params, gstate, jax.tree.map(lambda a: a[None], sig)

    step = jax.jit(jax.shard_map(
        gossip_step, mesh=mesh, in_specs=(P(GOSSIP_AXIS),) * 2,
        out_specs=(P(GOSSIP_AXIS),) * 3))
    rng = np.random.default_rng(0)
    params = rng.normal(size=(WORLD, 128)).astype(np.float32)
    gstate = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a),
                                  (WORLD,) + np.shape(a)).copy(),
        alg.init(jnp.zeros((128,), jnp.float32)))
    for _ in range(SELFTEST_ROUNDS):
        params, gstate, sig = jax.block_until_ready(step(params, gstate))
    rounds = (np.asarray(params), np.asarray(gstate.ps_weight))
    params, new_w = make_recovery_fn(alg, mesh)(params, gstate.ps_weight)
    gstate = gstate.replace(ps_weight=new_w)
    params, gstate, sig = jax.block_until_ready(step(params, gstate))
    return rounds, (np.asarray(params), np.asarray(gstate.ps_weight)), \
        float(np.asarray(sig["consensus_residual"])[0])


@pytest.fixture(scope="module")
def reference():
    return _reference_drill()


@pytest.fixture(scope="module")
def plain():
    return tchaos.run_drill("cpu", "xla")


def test_drill_matches_the_reference(reference, plain):
    (r_params, r_ps), (f_params, f_ps), r_residual = reference
    assert plain["failures"] == []
    assert plain["lane"] == "xla"
    assert np.array_equal(plain["round_ps_weight"], r_ps)
    assert np.array_equal(plain["round_params"], r_params)
    assert np.array_equal(plain["ps_weight"], f_ps)
    assert np.array_equal(plain["params"], f_params)
    # the drill's own readings: the mean held, recovery under the floor
    assert plain["drift"] < 1e-5
    assert plain["residual"] < 0.01 and r_residual < 0.01
    assert plain["health_lines"] == tchaos.SELFTEST_ROUNDS
    assert plain["launches"] == {"gossip_edge_start": 0,
                                 "gossip_edge_wait": 0}


def test_kernel_twins_give_the_plain_lanes_bits(plain):
    twins = tchaos.run_drill("cpu", KernelLane(interpret=True))
    assert twins["failures"] == []
    assert twins["lane"] == "pallas"
    for key in ("round_params", "round_ps_weight", "params", "ps_weight"):
        assert np.array_equal(twins[key], plain[key]), key


SPECS = [("drop:0->1@0:64", "ring", 8, 1),
         ("straggler:3@10:20;seed:7", "npeer-exponential", 16, 1),
         ("slice:0-3@2:5;nan:5@1:3", "exponential", 8, 2)]


@pytest.mark.parametrize("spec,topology,world,ppi", SPECS)
def test_describe_prints_the_references_lines(spec, topology, world, ppi,
                                              capsys):
    from stochastic_gradient_push_tpu.resilience import chaos as rchaos

    argv = ["--describe", spec, "--topology", topology, "--world",
            str(world), "--ppi", str(ppi)]
    assert rchaos.main(argv) == 0
    ref = capsys.readouterr().out
    assert tchaos.main(argv) == 0
    assert capsys.readouterr().out == ref
    assert "worst column-sum error" in ref


def test_describe_refusals_are_the_references(capsys):
    from stochastic_gradient_push_tpu.resilience import chaos as rchaos

    for argv in (["--describe", "drop:0->1@0:4", "--topology", "nope"],
                 ["--describe", "drop:0->9@0:4", "--world", "8"]):
        assert rchaos.main(argv) == 2
        ref = capsys.readouterr()
        assert tchaos.main(argv) == 2
        mine = capsys.readouterr()
        assert (mine.out, mine.err) == (ref.out, ref.err)


def test_selftest_script_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_chaos.py"),
         "--selftest", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(
        "chaos selftest: OK (world 8 ring, spec 'drop:0->1@0:64;seed:7': "
        "mean drift ")
    assert "xla lane, K2/K1 launched 0/0" in proc.stdout


def test_a_forced_kernel_lane_off_cuda_raises(capsys):
    with pytest.raises(KernelBackendError, match="needs a CUDA device"):
        tchaos.run_drill("cpu", "pallas")
    assert tchaos.main(["--selftest", "--device", "cpu", "--gossip_kernel",
                        "pallas"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_the_default_device_is_the_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tchaos.run_drill()
    assert tchaos.main(["--selftest"]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
