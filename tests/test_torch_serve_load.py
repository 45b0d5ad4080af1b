"""Serving a training run's consensus: the port's ``serve/load.py`` against
the reference's (``stochastic_gradient_push_tpu/serve/load.py``) on the
CPU, and ``models/convert.py::params_to_jax``.

* The same numpy state written as the reference's flax msgpack rank
  files and as the port's ``torch.save`` rank files (the LM's flax tree
  there, the port's ``TransformerLM`` names and transposed kernels here):
  ``load_consensus``'s params are bit-equal (``torch.equal`` after
  ``params_to_jax``, tolerance 0), a sync and an overlap set, with the
  same ``IngestInfo`` fields; they are the port's ``reshard_state(state,
  world, 1)`` row 0 bit for bit.
* An empty directory raises ``ConsensusIngestError`` in both; the newest
  set is picked unless a world is asked for; a torn set is rejected; a
  nonzero EF residual is reported forfeited.
* ``LMEngine`` over the ingested tree gives the same prefill and decode
  logits (exactly: the same parameters, the plain lane) as an engine
  built from the float64 Σx/Σw of the rank rows computed here.
* ``params_to_jax`` inverts ``params_from_jax`` bit for bit both ways.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.algorithms.api import GossipState
from stochastic_gradient_push_torch.models.convert import (
    flatten_tree, init_params, params_from_jax, params_to_jax)
from stochastic_gradient_push_torch.models.transformer import (
    TransformerConfig)
from stochastic_gradient_push_torch.serve import load as port
from stochastic_gradient_push_torch.serve.engine import LMEngine, ServeConfig
from stochastic_gradient_push_torch.supervise import reshard
from stochastic_gradient_push_torch.train.state import TrainState
from stochastic_gradient_push_torch.utils.checkpoint import CheckpointManager
from stochastic_gradient_push_tpu.serve import load as ref

CFG = TransformerConfig(vocab_size=64, d_model=16, n_layers=2, n_heads=2,
                        d_ff=32)
WORLD = 4


def _rows(world, seed, slots=0):
    """A world-stacked LM state in the flax layout: rows of the seed-0
    init plus per-rank noise, push-sum weights, an overlap FIFO."""
    rng = np.random.default_rng(seed)
    base = flatten_tree(init_params(CFG, 0))
    params = {k: (v[None] + 0.1 * rng.standard_normal(
        (world, *v.shape))).astype(np.float32) for k, v in base.items()}
    w = rng.uniform(0.5, 1.5, world).astype(np.float32)
    fifo = [({k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()},
             rng.uniform(0.1, 0.3, world).astype(np.float32))
            for _ in range(slots)]
    return params, w, fifo


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def _write_reference(directory, params, w, fifo, meta):
    """The reference's msgpack set, one file a rank."""
    import flax.serialization

    world = len(w)
    for r in range(world):
        state = {"params": _nest({k: v[r:r + 1] for k, v in params.items()}),
                 "gossip": {"ps_weight": w[r:r + 1],
                            "phase": np.full(1, 3, np.int32)},
                 "step": np.full(1, 5, np.int32)}
        if fifo:
            state["gossip"]["in_flight"] = {
                str(k): {"0": _nest({n: v[r:r + 1] for n, v in p.items()}),
                         "1": sw[r:r + 1]} for k, (p, sw) in enumerate(fifo)}
        with open(os.path.join(directory, f"checkpoint_r{r}_n{world}.ckpt"),
                  "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"state": state, "meta": meta}))


def _port_state(params, w, fifo, ef=None):
    """The same rows as the port's stacked TrainState (port names)."""
    port_params = params_from_jax(_nest(params))
    tensors = lambda flat: params_from_jax(_nest(flat))
    return TrainState(
        step=5, params=port_params,
        opt_state={n: torch.zeros_like(p) for n, p in port_params.items()},
        gossip=GossipState(
            phase=3, ps_weight=torch.from_numpy(w),
            in_flight=tuple((tensors(p), torch.from_numpy(sw))
                            for p, sw in fifo),
            ef_residual=ef))


def _write_port(directory, params, w, fifo, meta, ef=None):
    CheckpointManager(str(directory), world_size=len(w),
                      ranks=range(len(w))).save(
        _port_state(params, w, fifo, ef), meta)


@pytest.mark.parametrize("slots", [0, 2], ids=["sync", "overlap"])
def test_consensus_is_the_references_bit_for_bit(tmp_path, slots):
    params, w, fifo = _rows(WORLD, seed=slots, slots=slots)
    meta = {"step": 5, "plan": {"topology": "ring"}}
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    _write_reference(str(tmp_path / "ref"), params, w, fifo, meta)
    _write_port(tmp_path / "port", params, w, fifo, meta)
    want, want_meta, want_info = ref.load_consensus(str(tmp_path / "ref"))
    got, got_meta, got_info = port.load_consensus(str(tmp_path / "port"))
    assert got_meta == want_meta == meta
    want_flat, got_flat = flatten_tree(want), flatten_tree(
        params_to_jax(got))
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in want_flat.items():
        assert got_flat[k].dtype == v.dtype == np.float32
        assert np.array_equal(got_flat[k], v), k
    assert got_info.to_dict() == want_info.to_dict()
    assert got_info.in_flight_folded == slots and got_info.step == 5
    # row 0 of the port's own collapse
    state, _, _ = reshard.load_world_checkpoint(str(tmp_path / "port"), "",
                                                WORLD)
    collapsed = reshard.reshard_state(state, WORLD, 1)["params"]
    for n, t in got.items():
        assert np.array_equal(t.numpy(), collapsed[n][0]), n


def test_an_empty_directory_is_typed(tmp_path):
    with pytest.raises(ref.ConsensusIngestError):
        ref.load_consensus(str(tmp_path))
    with pytest.raises(port.ConsensusIngestError, match="no checkpoint_r"):
        port.load_consensus(str(tmp_path))


def test_the_newest_set_is_picked_unless_a_world_is_asked(tmp_path):
    for world, seed in ((8, 1), (WORLD, 2)):
        _write_port(tmp_path, *_rows(world, seed), {"step": world})
        time.sleep(0.02)
    os.utime(tmp_path / f"checkpoint_r0_n{WORLD}.ckpt")
    assert port.available_worlds(str(tmp_path)) == [WORLD, 8]
    assert port.load_consensus(str(tmp_path))[2].world == WORLD
    assert port.load_consensus(str(tmp_path), world=8)[2].step == 8
    os.remove(tmp_path / "checkpoint_r1_n8.ckpt")
    with pytest.raises(reshard.TornCheckpointError, match="torn"):
        port.load_consensus(str(tmp_path), world=8)


def test_a_nonzero_ef_residual_is_forfeited(tmp_path):
    params, w, _ = _rows(2, seed=4)
    ef = {n: torch.full_like(t, 1e-3) for n, t in
          params_from_jax(_nest(params)).items()}
    _write_port(tmp_path, params, w, [], {}, ef=ef)
    got, meta, info = port.load_consensus(str(tmp_path))
    assert info.ef_forfeited and info.step is None and meta == {}
    assert info.to_dict()["files"] == ["checkpoint_r0_n2.ckpt",
                                       "checkpoint_r1_n2.ckpt"]


def _logits(engine):
    """Prefill logits of one prompt, then three decode steps' logits."""
    slot, _ = engine.start([3, 1, 4, 1, 5, 9, 2], 16)
    out = [engine.last_logits.clone()]
    for _ in range(3):
        engine.step([slot])
        out.append(engine.last_logits[slot].clone())
    engine.finish(slot)
    return out


def test_the_engine_serves_the_ingested_consensus(tmp_path):
    params, w, fifo = _rows(3, seed=7, slots=1)
    _write_port(tmp_path, params, w, fifo, {"step": 9})
    got, _, info = port.load_consensus(str(tmp_path))
    assert info.world == 3 and info.in_flight_folded == 1
    # Σx/Σw computed here: rank rows then the slot, in float64
    w_sum = float(w.astype(np.float64).sum()) + float(
        fifo[0][1].astype(np.float64).sum())
    direct = {k: ((v.astype(np.float64).sum(0)
                   + fifo[0][0][k].astype(np.float64).sum(0)) / w_sum
                  ).astype(np.float32) for k, v in params.items()}
    config = ServeConfig(n_heads=CFG.n_heads, page_size=4, num_pages=16,
                         max_seqs=2, max_pages_per_seq=4)
    served = LMEngine(params_to_jax(got), config, device="cpu")
    plain = LMEngine(_nest(direct), config, device="cpu")
    for a, b in zip(_logits(served), _logits(plain)):
        assert torch.equal(a, b)


def test_params_to_jax_inverts_params_from_jax():
    tree = init_params(CFG, 3)
    state = params_from_jax(tree)
    back = flatten_tree(params_to_jax(state))
    flat = flatten_tree(tree)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    again = params_from_jax(params_to_jax(state))
    assert sorted(again) == sorted(state)
    for k, v in state.items():
        assert torch.equal(again[k], v), k
    # leading rank dims ride along
    stacked = {k: torch.stack([v, 2 * v]) for k, v in state.items()}
    for k, v in flatten_tree(params_to_jax(stacked)).items():
        assert v.shape[0] == 2 and np.array_equal(v[0], flat[k])
    with pytest.raises(ValueError, match="unexpected parameter"):
        params_to_jax({"embed.running_mean": torch.zeros(2)})


def test_ingest_info_is_json(tmp_path):
    _write_port(tmp_path, *_rows(2, seed=5), {"step": 1, "plan": {"a": 1}})
    info = port.load_consensus(str(tmp_path))[2]
    assert json.loads(json.dumps(info.to_dict()))["plan"] is True
