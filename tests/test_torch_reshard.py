"""The port's restart-boundary transform (``stochastic_gradient_push_torch/
supervise/reshard.py``) against the reference's
(``stochastic_gradient_push_tpu/supervise/reshard.py``) on the CPU.

* ``reshard_state`` and ``consensus_mean`` on the same numpy states,
  mapped between the two layouts (the reference's nested params, its
  ``{"0": {"0": params, "1": w}}`` FIFO and its int rows; the port's
  flat names and list FIFO): bit for bit (``np.array_equal`` and equal
  dtypes, tolerance 0) when shrinking 4 -> 2, growing 2 -> 4, collapsing
  to 1, with the overlap FIFO's slots folded, with an EF residual zeroed,
  with momentum and BatchNorm means and integer leaves.
* The reference's typed errors on the same bad inputs, with the same
  messages: a non-positive ps-weight, a world mismatch, an
  unrecognized FIFO, a slot that is no (params, ps_weight) pair, a
  negative in-flight weight; ``meta_key``'s ``CheckpointMetaError``.
* On disk (the port's rank files, written by ``CheckpointManager``): a
  set stacks to the saved rows; the files ``reshard_checkpoints`` writes
  hold the reference's ``reshard_state`` of that set bit for bit and are
  restored by ``CheckpointManager``; a torn set and a ``--checkpoint_all
  False`` set are rejected (the latter naming the flag); a stale
  ``.tmp.r*`` file is removed and a fresh one kept; an exact-world set
  wins; the newest usable set is picked and a torn one skipped; no
  usable set raises; a bf16 leaf is refused by name.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.algorithms.api import GossipState
from stochastic_gradient_push_torch.supervise import reshard as port
from stochastic_gradient_push_torch.train.state import TrainState
from stochastic_gradient_push_torch.utils.checkpoint import CheckpointManager
from stochastic_gradient_push_tpu.supervise import reshard as ref
from torch_ckpt_sets import assert_bit_equal, from_port, to_port

WORLD = 4


def _params(rng, n, scale=1.0):
    return {"conv": {"kernel": (scale * rng.normal(size=(n, 3, 3, 2))
                                ).astype(np.float32)},
            "dense": {"kernel": (scale * rng.normal(size=(n, 4, 5))
                                 ).astype(np.float32),
                      "bias": (scale * rng.normal(size=(n, 5))
                               ).astype(np.float32)}}


def _ref_state(n=WORLD, seed=0, slots=0, ef=False):
    """A world-stacked state in the reference's layout: nested params,
    momentum, BatchNorm statistics, the push-sum lane, int rows."""
    rng = np.random.default_rng(seed)
    state = {
        "params": _params(rng, n),
        "opt_state": {"momentum": rng.normal(size=(n, 4, 5)
                                             ).astype(np.float32)},
        "batch_stats": {"bn": {"mean": rng.normal(size=(n, 7)).astype(
            np.float32), "var": rng.uniform(0.5, 2, size=(n, 7)).astype(
            np.float32)}},
        "gossip": {
            "ps_weight": rng.uniform(0.5, 1.5, size=n).astype(np.float32),
            "phase": (np.arange(n) % 3).astype(np.int32),
            "in_flight": None},
        "step": np.full((n,), 17, np.int32),
    }
    if slots:
        state["gossip"]["in_flight"] = {
            str(k): {"0": _params(rng, n, scale=0.5 if k == 0 else 0.0),
                     "1": (rng.uniform(0.1, 0.5, size=n) if k == 0
                           else np.zeros(n)).astype(np.float32)}
            for k in range(slots)}
    if ef:
        state["gossip"]["ef_residual"] = _params(rng, n, scale=1e-3)
    return state


CASES = {
    # (old world, new world, FIFO slots, EF residual)
    "shrink-4-2": (4, 2, 0, False),
    "grow-2-4": (2, 4, 0, False),
    "collapse-4-1": (4, 1, 0, False),
    "overlap-slots-folded": (4, 2, 2, False),
    "ef-residual-zeroed": (4, 2, 0, True),
    "overlap-and-ef": (4, 3, 1, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reshard_state_is_the_references_bit_for_bit(case):
    old, new, slots, ef = CASES[case]
    state = _ref_state(old, seed=len(case), slots=slots, ef=ef)
    want = ref.reshard_state(state, old, new)
    got = port.reshard_state(to_port(state), old, new)
    assert_bit_equal(from_port(got), want)
    # the leaf rules, read off the port's result
    assert np.all(got["gossip"]["ps_weight"] == 1)
    assert np.all(got["gossip"]["phase"] == 0)
    assert np.all(got["step"] == 17)
    for slot in got["gossip"]["in_flight"]:
        assert not any(np.any(a) for a in slot["params"].values())
    if ef:
        assert not any(np.any(a) for a in
                       got["gossip"]["ef_residual"].values())
    for n, a in got["params"].items():
        assert all(np.array_equal(a[r], a[0]) for r in range(new)), n
    np.testing.assert_array_equal(
        got["batch_stats"]["bn.mean"][0],
        np.asarray(state["batch_stats"]["bn"]["mean"], np.float64).mean(
            0).astype(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_mean_is_the_references_bit_for_bit(case):
    old, _, slots, ef = CASES[case]
    state = _ref_state(old, seed=len(case), slots=slots, ef=ef)
    want = ref.consensus_mean(state)
    got = port.consensus_mean(to_port(state))
    assert sorted(got) == sorted(k.replace("/", ".") for k in want)
    for k, w in want.items():
        g = got[k.replace("/", ".")]
        assert g.dtype == w.dtype == np.float64
        assert np.array_equal(g, w), k


def _bad(kind):
    state = _ref_state()
    g = state["gossip"]
    if kind == "ps-weight-zero":
        g["ps_weight"] = np.zeros(WORLD, np.float32)
    elif kind == "ps-weight-nan":
        g["ps_weight"] = np.full(WORLD, np.nan, np.float32)
    elif kind == "fifo-not-slots":
        g["in_flight"] = {"params": np.zeros((WORLD, 2))}
    elif kind == "slot-not-a-pair":
        g["in_flight"] = {"0": {"x": 1}}
    elif kind == "slot-negative-weight":
        g["in_flight"] = {"0": {"0": _params(np.random.default_rng(1), WORLD),
                                "1": -np.ones(WORLD, np.float32)}}
    return state


def _port_bad(kind, state):
    if kind == "fifo-not-slots":
        out = to_port({**state, "gossip": {**state["gossip"],
                                           "in_flight": None}})
        out["gossip"]["in_flight"] = {"params": np.zeros((WORLD, 2))}
        return out
    if kind == "slot-not-a-pair":
        out = to_port({**state, "gossip": {**state["gossip"],
                                           "in_flight": None}})
        out["gossip"]["in_flight"] = [{"x": 1}]
        return out
    return to_port(state)


@pytest.mark.parametrize("kind,old", [
    ("ps-weight-zero", WORLD), ("ps-weight-nan", WORLD),
    ("fifo-not-slots", WORLD), ("slot-not-a-pair", WORLD),
    ("slot-negative-weight", WORLD), ("world-mismatch", WORLD + 1)])
def test_typed_errors_are_the_references(kind, old):
    state = _bad(kind)
    with pytest.raises(ValueError) as want:
        ref.reshard_state(state, old, 2)
    with pytest.raises(ValueError) as got:
        port.reshard_state(_port_bad(kind, state), old, 2)
    assert str(got.value) == str(want.value)


def test_new_world_below_one_is_refused():
    with pytest.raises(ValueError, match="new_world must be >= 1"):
        port.reshard_state(to_port(_ref_state()), WORLD, 0)


@pytest.mark.parametrize("meta,key", [({"epoch": 1}, "plan"),
                                      ([1, 2], "epoch"), ({}, "step")])
def test_meta_key_errors_are_the_references(meta, key):
    with pytest.raises(ref.CheckpointMetaError) as want:
        ref.meta_key(meta, key, "ctx")
    with pytest.raises(port.CheckpointMetaError) as got:
        port.meta_key(meta, key, "ctx")
    assert str(got.value) == str(want.value)
    assert got.value.key == want.value.key
    assert port.meta_key({"plan": 3}, "plan") == 3


# -- on disk ------------------------------------------------------------------


def _train_state(state):
    """A port-layout numpy state as the stacked TrainState the trainer
    saves (step and phase: row 0's ints)."""
    t = lambda tree: {n: torch.from_numpy(np.array(a)) for n, a in
                      tree.items()}
    g = state["gossip"]
    return TrainState(
        step=int(state["step"][0]), params=t(state["params"]),
        opt_state=t(state["opt_state"]), batch_stats=t(state["batch_stats"]),
        gossip=GossipState(
            phase=int(g["phase"][0]),
            ps_weight=torch.from_numpy(np.array(g["ps_weight"])),
            in_flight=tuple((t(s["params"]), torch.from_numpy(
                np.array(s["ps_weight"]))) for s in g["in_flight"]),
            ef_residual=t(g["ef_residual"]) if "ef_residual" in g
            else None))


def _save_set(directory, world, seed=0, slots=0, ef=False, meta=None):
    """A world's rank files as the trainer writes them; returns the
    port-layout numpy state they hold (phase and step as their rows)."""
    state = to_port(_ref_state(world, seed=seed, slots=slots, ef=ef))
    state["gossip"]["phase"] = np.full(world, 2, np.int64)
    state["step"] = np.full(world, 17, np.int64)
    CheckpointManager(str(directory), world_size=world,
                      ranks=range(world)).save(
        _train_state(state), meta or {"epoch": 3, "itr": 0})
    return state


def test_a_set_stacks_to_the_saved_rows(tmp_path):
    want = _save_set(tmp_path, WORLD, slots=1, ef=True)
    got, meta, paths = port.load_world_checkpoint(str(tmp_path), "", WORLD)
    assert meta == {"epoch": 3, "itr": 0} and len(paths) == WORLD
    assert_bit_equal(from_port(got), from_port(want))


@pytest.mark.parametrize("slots,ef", [(0, False), (2, True)],
                         ids=["sync", "overlap-ef"])
def test_reshard_checkpoints_writes_the_references_state(tmp_path, slots, ef):
    state = _save_set(tmp_path, WORLD, slots=slots, ef=ef, meta={
        "epoch": 3, "itr": 1, "health": {"x": 1}})
    plan = {"topology": "ring"}
    report = port.reshard_checkpoints(str(tmp_path), "", WORLD, 2, plan=plan)
    want = ref.reshard_state(from_port(state), WORLD, 2)
    got, meta, paths = port.load_world_checkpoint(str(tmp_path), "", 2)
    assert_bit_equal(from_port(got), want)
    assert [os.path.basename(p) for p in report.files_out] == [
        "checkpoint_r0_n2.ckpt", "checkpoint_r1_n2.ckpt"]
    assert report.old_world == WORLD and report.new_world == 2
    assert report.mean_drift < 1e-6
    assert "health" not in meta and meta["plan"] == plan
    assert meta["reshard"] == report.to_dict() | {"files_out": []}
    assert meta["epoch"] == 3 and meta["itr"] == 1
    # the old set stays (the rollback path)
    assert os.path.isfile(tmp_path / f"checkpoint_r3_n{WORLD}.ckpt")
    # the trainer's manager restores it at the new world
    template = _train_state(to_port(_ref_state(2, seed=9, slots=slots,
                                               ef=ef)))
    restored, rmeta = CheckpointManager(
        str(tmp_path), world_size=2, ranks=[0, 1]).restore(template)
    assert rmeta["epoch"] == 3 and restored.gossip.phase == 0
    for n, a in want["params"].items():
        for leaf, arr in a.items() if isinstance(a, dict) else []:
            assert np.array_equal(
                restored.params[f"{n}.{leaf}"].numpy(), arr)


def test_each_process_writes_its_own_ranks(tmp_path):
    _save_set(tmp_path, WORLD)
    a = port.reshard_checkpoints(str(tmp_path), "", WORLD, 2, ranks=[1])
    assert [os.path.basename(p) for p in a.files_out] == [
        "checkpoint_r1_n2.ckpt"]
    assert not os.path.exists(tmp_path / "checkpoint_r0_n2.ckpt")
    b = port.reshard_checkpoints(str(tmp_path), "", WORLD, 2, ranks=[0])
    assert os.path.isfile(b.files_out[0])
    one = torch.load(a.files_out[0], weights_only=True)["state"]
    zero = torch.load(b.files_out[0], weights_only=True)["state"]
    for n in one["params"]:
        assert torch.equal(one["params"][n], zero["params"][n])


def test_a_torn_set_is_rejected(tmp_path):
    _save_set(tmp_path, WORLD)
    os.remove(tmp_path / "checkpoint_r2_n4.ckpt")
    with pytest.raises(port.TornCheckpointError, match="torn"):
        port.load_world_checkpoint(str(tmp_path), "", WORLD)
    with pytest.raises(port.TornCheckpointError, match="no checkpoint_r"):
        port.load_world_checkpoint(str(tmp_path), "", 8)


def test_a_checkpoint_all_false_set_is_refused_by_name(tmp_path):
    state = to_port(_ref_state(WORLD))
    CheckpointManager(str(tmp_path), world_size=WORLD, ranks=range(WORLD),
                      all_workers=False).save(
        _train_state(state), {"epoch": 1})
    assert os.listdir(tmp_path) == ["checkpoint_r0_n4.ckpt"]
    with pytest.raises(port.TornCheckpointError,
                       match="--checkpoint_all False"):
        port.load_world_checkpoint(str(tmp_path), "", WORLD)
    with pytest.raises(port.TornCheckpointError,
                       match=r"cross-world resume: .*--checkpoint_all False"):
        port.maybe_cross_world_reshard(str(tmp_path), "", 2)


def test_stale_staging_files_go_and_fresh_ones_stay(tmp_path):
    stale = tmp_path / "checkpoint_r0_n4.ckpt.tmp.r0"
    fresh = tmp_path / "checkpoint_r1_n4.ckpt.tmp.r1"
    other = tmp_path / "x_checkpoint_r0_n4.ckpt.tmp.r0"
    for p in (stale, fresh, other):
        p.write_bytes(b"partial")
    old = time.time() - 2 * port.STALE_TMP_AGE_S
    os.utime(stale, (old, old))
    os.utime(other, (old, old))
    assert port.gc_stale_tmp(str(tmp_path)) == [str(stale)]
    assert fresh.exists() and other.exists()
    assert port.gc_stale_tmp(str(tmp_path), tag="x_") == [str(other)]


def test_an_exact_world_set_wins(tmp_path):
    _save_set(tmp_path, WORLD)
    _save_set(tmp_path, 2, seed=5)
    assert port.maybe_cross_world_reshard(str(tmp_path), "", 2) is None
    assert port.maybe_cross_world_reshard(str(tmp_path), "", 8) is not None


def test_the_newest_usable_set_is_picked(tmp_path):
    _save_set(tmp_path, 2, seed=1)
    for r in range(2):
        os.utime(tmp_path / f"checkpoint_r{r}_n2.ckpt", (1, 1))
    _save_set(tmp_path, 8, seed=2)
    report = port.maybe_cross_world_reshard(str(tmp_path), "", WORLD)
    assert report.old_world == 8
    # a torn newest set is skipped for the older usable one
    os.remove(tmp_path / "checkpoint_r5_n8.ckpt")
    for r in range(WORLD):
        os.remove(tmp_path / f"checkpoint_r{r}_n{WORLD}.ckpt")
    report = port.maybe_cross_world_reshard(str(tmp_path), "", WORLD)
    assert report.old_world == 2
    got, _, _ = port.load_world_checkpoint(str(tmp_path), "", WORLD)
    want = ref.reshard_state(from_port(port.load_world_checkpoint(
        str(tmp_path), "", 2)[0]), 2, WORLD)
    assert_bit_equal(from_port(got), want)


def test_no_usable_set_raises_naming_each(tmp_path):
    _save_set(tmp_path, 8)
    os.remove(tmp_path / "checkpoint_r3_n8.ckpt")
    with pytest.raises(port.TornCheckpointError,
                       match=r"no checkpoint set .* world 8: torn"):
        port.maybe_cross_world_reshard(str(tmp_path), "", 2)
    assert port.maybe_cross_world_reshard(str(tmp_path / "none"), "",
                                          2) is None


def test_a_bf16_leaf_is_refused_by_name(tmp_path):
    _save_set(tmp_path, 2)
    path = tmp_path / "checkpoint_r1_n2.ckpt"
    blob = torch.load(path, weights_only=True)
    blob["state"]["params"]["dense.bias"] = blob["state"]["params"][
        "dense.bias"].bfloat16()
    torch.save(blob, path)
    with pytest.raises(ValueError, match="params/dense.bias is torch.bfloat16"):
        port.load_world_checkpoint(str(tmp_path), "", 2)


def test_a_malformed_meta_is_typed(tmp_path):
    _save_set(tmp_path, 2)
    path = tmp_path / "checkpoint_r0_n2.ckpt"
    blob = torch.load(path, weights_only=True)
    torch.save({"state": blob["state"], "meta": json.dumps([1])}, path)
    with pytest.raises(port.CheckpointMetaError, match="mapping"):
        port.load_world_checkpoint(str(tmp_path), "", 2)
