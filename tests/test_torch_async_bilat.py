"""Wall-clock-asynchronous AD-PSGD (``train/async_bilat.py``) against the
reference's ``AsyncBilateralAverager`` on the same snapshot.

* One round's displacement ``(x[partner] - x) * 0.5`` and its adoption
  bit-equal to the reference's (the counterparts of the reference's
  ``tests/test_async_bilat.py`` displacement and adoption checks), over
  several rounds of the matching schedule;
* the mailbox is overwritten, not queued;
* a fixed staleness: published at step k, the deposit waited for,
  adopted at k + 3, so ``staleness_summary`` reports δ = 3 with the
  reference's keys; and at δ = 1 a two-rank trajectory equal to the
  reference's (pure averaging cycles there, in both);
* ``min_interval_s`` paces the rounds, and ``stop()`` returns at once
  during a long interval;
* a thread that dies makes the next adoption raise;
* the Trainer with ``bilat_async`` at world 4 on ``tiny_cnn`` keeps its
  replicas far closer together than a control without communication.
"""

import sys
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.topology import (
    DynamicBipartiteExponentialGraph, build_pairing_schedule)
from stochastic_gradient_push_torch.train.async_bilat import (
    AsyncBilateralAverager)

jax = pytest.importorskip("jax")
ref_ab = pytest.importorskip("stochastic_gradient_push_tpu.train.async_bilat")

WORLD = 4


def _pairing(world=WORLD):
    return build_pairing_schedule(
        DynamicBipartiteExponentialGraph(world, peers_per_itr=1))


def _snapshot(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(WORLD, 3, 3, 2, 4)).astype(np.float32),
            "bias": rng.normal(size=(WORLD, 7)).astype(np.float32) * 1e3,
            "scale": rng.normal(size=(WORLD,)).astype(np.float32)}


def _wait_rounds(av, n: int, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while av._rounds < n:
        assert time.monotonic() < deadline, "the averaging thread never " \
                                            "deposited"
        time.sleep(0.002)


def test_pairing_matches_the_reference():
    from stochastic_gradient_push_tpu.topology import (
        DynamicBipartiteExponentialGraph as RefGraph)
    from stochastic_gradient_push_tpu.topology import (
        build_pairing_schedule as ref_pairing)

    np.testing.assert_array_equal(
        _pairing(), ref_pairing(RefGraph(WORLD, peers_per_itr=1)))


def test_displacement_and_adoption_bit_equal_over_rounds():
    import jax.numpy as jnp

    pairing = _pairing()
    port = AsyncBilateralAverager(pairing).start()
    ref = ref_ab.AsyncBilateralAverager(pairing).start()
    try:
        for k in range(2 * len(pairing) + 1):
            snap = _snapshot(k)
            live = {n: torch.from_numpy(a.copy()) for n, a in snap.items()}
            port.publish(k, live)
            ref.publish(k, {n: jnp.asarray(a) for n, a in snap.items()})
            _wait_rounds(port, k + 1)
            _wait_rounds(ref, k + 1)
            # the live params moved on after the snapshot: the adoption
            # adds the snapshot's displacement to what is there now
            moved = {n: t * 0.75 - 1 for n, t in live.items()}
            # copies: jnp.asarray may share the numpy buffer, which the
            # port's in-place adoption then writes
            ref_moved = {n: jnp.array(t.numpy(), copy=True)
                         for n, t in moved.items()}
            new, adopted = port.maybe_adopt(k + 1, moved)
            rnew, radopted = ref.maybe_adopt(k + 1, ref_moved)
            assert adopted and radopted
            for n in snap:
                np.testing.assert_array_equal(new[n].numpy(),
                                              np.asarray(rnew[n]))
            assert new["conv"] is moved["conv"]    # in place
    finally:
        port.stop()
        ref.stop()
    assert port.staleness_summary() == ref.staleness_summary()


def test_staleness_one_trajectory_equals_the_reference():
    """At δ = 1 (each step publishes, adopts the last round, and the
    thread finishes this step's round before the next), pure averaging of
    two ranks cycles with period 6 in both: the reference publishes the
    params before it adopts, so a round's snapshot lacks the displacement
    adopted after it, and each disagreement is corrected twice.  The port
    keeps that order, and with it the cycle."""
    import jax.numpy as jnp

    pairing = build_pairing_schedule(
        DynamicBipartiteExponentialGraph(2, peers_per_itr=1))

    def run(av, wrap, unwrap):
        live = wrap(np.array([[0.0], [2.0]], np.float32))
        traj = []
        av.start()
        try:
            for k in range(1, 8):
                av.publish(k, live)
                live = av.maybe_adopt(k, live)[0]
                _wait_rounds(av, k)
                traj.append(unwrap(live).ravel().tolist())
        finally:
            av.stop()
        return traj, av.staleness_summary()

    port = run(AsyncBilateralAverager(pairing),
               lambda a: {"w": torch.from_numpy(a)},
               lambda d: d["w"].numpy())
    ref = run(ref_ab.AsyncBilateralAverager(pairing),
              lambda a: {"w": jnp.asarray(a)},
              lambda d: np.asarray(d["w"]))
    assert port == ref
    assert port[0] == [[0, 2], [1, 1], [2, 0], [2, 0], [1, 1], [0, 2],
                       [0, 2]]
    assert port[1]["staleness_max"] == 1


def test_displacement_is_half_the_pair_gap():
    av = AsyncBilateralAverager(_pairing()).start()
    params = {"w": torch.tensor([[0.0], [2.0], [4.0], [6.0]])}
    try:
        av.publish(0, params)
        _wait_rounds(av, 1)
        new, adopted = av.maybe_adopt(0, {"w": params["w"].clone()})
    finally:
        av.stop()
    assert adopted
    expect = np.array([0.0, 2, 4, 6])
    expect = expect + (expect[av.pairing[0]] - expect) * 0.5
    np.testing.assert_array_equal(new["w"].numpy().ravel(),
                                  expect.astype(np.float32))


def test_mailbox_overwrites_not_queues():
    av = AsyncBilateralAverager(_pairing()).start()
    p1 = {"w": torch.tensor([[0.0], [2.0], [4.0], [6.0]])}
    p2 = {"w": torch.full((4, 1), 10.0)}
    try:
        av.publish(0, p1)
        _wait_rounds(av, 1)
        av.publish(1, p2)
        _wait_rounds(av, 2)
        new, adopted = av.maybe_adopt(2, {"w": p2["w"].clone()})
        again, adopted_again = av.maybe_adopt(3, new)
    finally:
        av.stop()
    # consensus params give a zero displacement: the second round's
    # result replaced the first's instead of queueing behind it
    assert adopted and not adopted_again
    np.testing.assert_array_equal(new["w"].numpy(), p2["w"].numpy())
    assert av.staleness_summary()["adoptions"] == 1


def test_fixed_staleness_is_reported_with_the_reference_keys():
    port = AsyncBilateralAverager(_pairing()).start()
    ref = ref_ab.AsyncBilateralAverager(_pairing()).start()
    snap = _snapshot(0)
    try:
        for av, live in ((port, {n: torch.from_numpy(a.copy())
                                 for n, a in snap.items()}),
                         (ref, {n: jax.numpy.asarray(a)
                                for n, a in snap.items()})):
            assert av.maybe_adopt(4, live) == (live, False)
            av.publish(5, live)
            _wait_rounds(av, 1)
            _, adopted = av.maybe_adopt(8, live)
            assert adopted
    finally:
        port.stop()
        ref.stop()
    want = {"adoptions": 1, "rounds": 1, "staleness_mean": 3.0,
            "staleness_p50": 3.0, "staleness_max": 3}
    assert port.staleness_summary() == ref.staleness_summary() == want
    empty = AsyncBilateralAverager(_pairing())
    assert empty.staleness_summary() == {"adoptions": 0, "rounds": 0}


def test_min_interval_paces_rounds_and_stop_is_prompt():
    av = AsyncBilateralAverager(_pairing(), min_interval_s=0.3).start()
    try:
        t0 = time.monotonic()
        for k in range(3):
            av.publish(k, {"w": torch.full((WORLD, 2), float(k))})
            _wait_rounds(av, k + 1)
        # three rounds take at least two whole intervals
        assert time.monotonic() - t0 >= 0.55
    finally:
        slow = AsyncBilateralAverager(_pairing(), min_interval_s=60.0)
        slow.start()
        slow.publish(0, {"w": torch.zeros(WORLD, 1)})
        _wait_rounds(slow, 1)
        t0 = time.monotonic()
        slow.stop()
        # stop() does not wait out the 60 s interval
        assert time.monotonic() - t0 < 2.0
        assert not slow.alive
        av.stop()


# the thread's death is the point: its re-raised error reaches the hook
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_thread_makes_the_adoption_raise():
    av = AsyncBilateralAverager(_pairing()).start()
    try:
        # a leaf without a rank dim: the round's indexing fails
        av.publish(0, {"w": torch.zeros(())})
        deadline = time.monotonic() + 10
        while av.alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not av.alive
        with pytest.raises(RuntimeError, match="thread died"):
            av.maybe_adopt(1, {"w": torch.zeros(())})
    finally:
        av.stop()


def test_publish_and_adopt_under_a_short_switch_interval():
    """Stress: quick publish/adopt cycles with the interpreter switching
    threads every microsecond.  Every adopted displacement is the round
    of the snapshot its recorded read step published (a torn or stale
    mailbox would pair one round's step with another's values), never
    read after it is adopted, and never adopted twice."""
    pairing = _pairing()
    ranks = torch.arange(1, WORLD + 1, dtype=torch.float32)[:, None]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    av = AsyncBilateralAverager(pairing).start()
    try:
        deadline = time.monotonic() + 20
        for k in range(1, 400):
            assert time.monotonic() < deadline
            av.publish(k, {"w": ranks * k})
            new, adopted = av.maybe_adopt(k, {"w": torch.zeros(WORLD, 1)})
            if not adopted:
                continue
            read, at = av._adoptions[-1]
            assert read <= at == k
            x = (ranks * read).numpy()
            assert any(np.array_equal(new["w"].numpy(),
                                      (x[row] - x) * np.float32(0.5))
                       for row in pairing), (read, k)
    finally:
        av.stop()
        sys.setswitchinterval(old)
    s = av.staleness_summary()
    assert 0 < s["adoptions"] <= s["rounds"]


def test_bad_pairing_is_refused():
    with pytest.raises(ValueError, match="n_phases, world"):
        AsyncBilateralAverager(np.arange(4))


def test_trainer_bilat_async_converges_replicas(tmp_path):
    """Local SGD on the step and the host averaging keep the replicas in
    consensus: their spread stays far below a no-communication control,
    and the run reports its measured staleness."""
    from stochastic_gradient_push_torch.algorithms.api import GossipAlgorithm
    from stochastic_gradient_push_torch.data.pipeline import (
        DistributedSampler, ShardedLoader)
    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train.loop import (Trainer,
                                                           TrainerConfig)
    from stochastic_gradient_push_torch.train.step import (make_model,
                                                           replica_spread)

    batch, classes, img = 4, 8, 12
    images, labels = synthetic_classification(
        WORLD * batch * 6, num_classes=classes, image_size=img, seed=3)

    def run(bilat_async):
        cfg = TrainerConfig(
            push_sum=False, bilat=True, bilat_async=bilat_async,
            graph_class=DynamicBipartiteExponentialGraph,
            lr=0.1, warmup=False, lr_schedule={},
            batch_size=batch, num_epochs=3, num_itr_ignore=0,
            checkpoint_dir=str(tmp_path / f"async_{bilat_async}"),
            num_classes=classes, verbose=False, heartbeat_timeout=0,
            train_fast=True)

        class _Local(Trainer):
            def make_algorithm(self, ppi):
                return GossipAlgorithm()

        cls = Trainer if bilat_async else _Local
        trainer = cls(cfg, make_model("tiny_cnn", num_classes=classes),
                      StackedTransport(WORLD), device="cpu")
        state = trainer.init_state()
        sampler = DistributedSampler(len(images), WORLD)
        loader = ShardedLoader(images, labels, batch, sampler)
        state, result = trainer.fit(state, loader, sampler, None)
        return replica_spread(state, GossipAlgorithm())["mean_spread"], \
            result

    spread_async, result = run(True)
    spread_local, local = run(False)
    stats = result["async_bilat"]
    assert stats["adoptions"] > 0 and stats["rounds"] >= stats["adoptions"]
    assert stats["staleness_mean"] >= 0.0
    assert "async_bilat" not in local
    assert spread_async < spread_local * 0.5, (spread_async, spread_local)
