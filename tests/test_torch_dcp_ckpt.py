"""The ``torch.distributed.checkpoint`` backend (``--ckpt_backend orbax``,
``stochastic_gradient_push_torch/utils/dcp_ckpt.py``) on the CPU, as the
reference's ``tests/test_ckpt_streaming.py`` holds its orbax manager:

* a round trip of a train state (params, momentum, statistics, the
  push-sum weight, an overlap FIFO, an EF residual, step and phase) and
  of a plain dict, every tensor bit-equal, the meta as saved;
* retention: the latest step wins and at most ``max_to_keep`` steps
  stay; the best model survives retention in its own root; a step
  directory without ``.metadata`` (an unfinished save) is neither the
  latest nor pruned;
* an asynchronous save returns once its host copy is made: the state
  changed after it does not reach the checkpoint; ``wait()`` lands it, a
  second save waits for the first, and a failed write raises at
  ``wait()``;
* a checkpoint of another world is refused by name;
* two gloo processes saving different rows of one shared root each get
  their own rows back (a plain tensor would keep one process's copy:
  DCP's planner takes it for replicated).
"""

import dataclasses
import json
import os
import sys

import pytest
import torch
from torch.distributed.checkpoint.api import CheckpointException

from stochastic_gradient_push_torch.algorithms.api import GossipState
from stochastic_gradient_push_torch.train.state import TrainState
from stochastic_gradient_push_torch.utils.dcp_ckpt import DcpCheckpointManager
from torch_launch import torchrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def _state(seed=0, slots=1, ef=True):
    g = torch.Generator().manual_seed(seed)
    t = lambda *s: torch.randn(*s, generator=g)
    params = {"a.weight": t(WORLD, 3, 2), "b.bias": t(WORLD, 5)}
    return TrainState(
        step=7 + seed, params=params,
        opt_state={n: t(*p.shape) for n, p in params.items()},
        batch_stats={"bn.running_mean": t(WORLD, 4)},
        gossip=GossipState(
            phase=2, ps_weight=t(WORLD).abs(),
            in_flight=tuple(({n: t(*p.shape) for n, p in params.items()},
                             t(WORLD).abs()) for _ in range(slots)),
            ef_residual=({n: t(*p.shape) for n, p in params.items()}
                         if ef else None)))


def _tensors(state):
    out = {f"params/{n}": p for n, p in state.params.items()}
    out.update({f"opt/{n}": p for n, p in state.opt_state.items()})
    out.update({f"bn/{n}": p for n, p in state.batch_stats.items()})
    out["ps"] = state.gossip.ps_weight
    for k, (p, w) in enumerate(state.gossip.in_flight):
        out[f"fifo{k}/w"] = w
        out.update({f"fifo{k}/{n}": v for n, v in p.items()})
    for n, v in (state.gossip.ef_residual or {}).items():
        out[f"ef/{n}"] = v
    return out


def _assert_equal(a, b):
    assert (a.step, a.gossip.phase) == (b.step, b.gossip.phase)
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("slots,ef", [(0, False), (2, True)],
                         ids=["sgp", "osgp-ef"])
def test_round_trip(tmp_path, async_save, slots, ef):
    cm = DcpCheckpointManager(str(tmp_path), tag="t_", world_size=WORLD,
                              async_save=async_save)
    assert not cm.exists()
    state = _state(slots=slots, ef=ef)
    path = cm.save(state, {"epoch": 3, "itr": 7}, is_best=True)
    cm.wait()
    assert cm.exists() and path == os.path.join(
        str(tmp_path), f"t_dcp_r0_n{WORLD}", "3")
    assert os.path.isfile(os.path.join(path, ".metadata"))
    got, meta = cm.restore(_state(seed=5, slots=slots, ef=ef))
    _assert_equal(got, state)
    assert meta == {"epoch": 3, "itr": 7}
    best, _ = cm.restore_best(_state(seed=6, slots=slots, ef=ef))
    _assert_equal(best, state)
    cm.close()


def test_a_plain_dict_round_trips(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD,
                              async_save=False)
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "ps_weight": torch.ones(WORLD, 1)}
    cm.save(tree, {"epoch": 1})
    got, meta = cm.restore({"params": {"w": torch.zeros(2, 3)},
                            "ps_weight": torch.zeros(WORLD, 1)})
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert torch.equal(got["ps_weight"], tree["ps_weight"])
    assert meta == {"epoch": 1}


def test_retention_keeps_the_latest_steps(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD, max_to_keep=2)
    for epoch in range(5):
        cm.save(_state(seed=epoch), {"epoch": epoch}, epoch_id=epoch)
    cm.wait()
    kept = sorted(int(d) for d in os.listdir(cm.checkpoint_path)
                  if d.isdigit())
    assert kept == [3, 4]
    got, meta = cm.restore(_state(seed=9))
    assert meta["epoch"] == 4
    _assert_equal(got, _state(seed=4))
    assert [h["step"] for h in cm.history] == list(range(5))
    assert all(h["stage_s"] >= 0 and h["write_s"] > 0 and h["bytes"] > 0
               for h in cm.history)


def test_the_best_model_survives_retention(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD, max_to_keep=2)
    cm.save(_state(seed=1), {"epoch": 0}, epoch_id=0, is_best=True)
    for epoch in range(1, 5):
        cm.save(_state(seed=2), {"epoch": epoch}, epoch_id=epoch)
    got, meta = cm.restore_best(_state(seed=3))
    assert meta["epoch"] == 0
    _assert_equal(got, _state(seed=1))
    assert 0 not in [int(d) for d in os.listdir(cm.checkpoint_path)
                     if d.isdigit()]


def test_an_unfinished_step_is_ignored(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD, max_to_keep=1,
                              async_save=False)
    cm.save(_state(seed=1), {"epoch": 1})
    # a save that died before DCP wrote .metadata (its last file)
    os.makedirs(os.path.join(cm.checkpoint_path, "9"))
    with open(os.path.join(cm.checkpoint_path, "9", "__0_0.distcp"),
              "wb") as f:
        f.write(b"partial")
    assert cm.latest_step() == 1
    _, meta = cm.restore(_state())
    assert meta["epoch"] == 1
    cm.save(_state(seed=2), {"epoch": 2})
    assert sorted(os.listdir(cm.checkpoint_path)) == ["2", "9", "best"]
    empty = DcpCheckpointManager(str(tmp_path / "x"), world_size=WORLD)
    os.makedirs(os.path.join(empty.checkpoint_path, "4"))
    assert not empty.exists()
    with pytest.raises(FileNotFoundError, match="no DCP checkpoint"):
        empty.restore(_state())


def test_an_async_save_stages_before_it_returns(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD)
    state = _state(seed=1)
    want = _state(seed=1)
    cm.save(state, {"epoch": 1})
    # the run goes on and changes the state in place
    for p in state.params.values():
        p.add_(100.0)
    cm.save(_state(seed=2), {"epoch": 2})   # waits for the first
    cm.wait()
    steps = sorted(d for d in os.listdir(cm.checkpoint_path) if d.isdigit())
    assert steps == ["1", "2"]
    got, meta = cm.restore(_state())
    assert meta["epoch"] == 2
    # step 1 holds the state as it was at save time
    first = DcpCheckpointManager(str(tmp_path), world_size=WORLD,
                                 max_to_keep=3)
    os.rename(os.path.join(cm.checkpoint_path, "2"),
              os.path.join(str(tmp_path), "held"))
    got, meta = first.restore(_state())
    assert meta["epoch"] == 1
    _assert_equal(got, want)


def test_a_failed_write_raises_at_wait(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD)
    # a file where the save's staging directory goes: the write fails
    with open(os.path.join(cm.checkpoint_path, ".tmp.1"), "w") as f:
        f.write("in the way")
    cm.save({"w": torch.ones(2)}, {"epoch": 1})
    with pytest.raises(CheckpointException):
        cm.wait()
    assert not cm.exists()
    cm.wait()   # the failure is raised once


def test_another_world_is_refused_by_name(tmp_path):
    DcpCheckpointManager(str(tmp_path), world_size=8, async_save=False).save(
        _state(), {"epoch": 1})
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD)
    assert cm.discover_worlds() == [8]
    with pytest.raises(NotImplementedError,
                       match=r"cross-world resume: .*--ckpt_backend orbax.*"
                             r"world \[8\], not 4"):
        cm.refuse_other_worlds()


_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from stochastic_gradient_push_torch.algorithms.api import GossipState
from stochastic_gradient_push_torch.train.state import TrainState
from stochastic_gradient_push_torch.utils.dcp_ckpt import DcpCheckpointManager

dist.init_process_group("gloo")
rank = dist.get_rank()
cm = DcpCheckpointManager(sys.argv[2], world_size=2)
row = lambda v, *s: torch.full((1, *s), float(v))
cm.save(TrainState(step=4, params={"w": row(rank + 1, 3)},
                   opt_state={"w": row(10 * (rank + 1), 3)},
                   gossip=GossipState(phase=1, ps_weight=row(rank + 0.5))),
        {"epoch": 1})
zero = lambda *s: torch.zeros(1, *s)
got, meta = cm.restore(TrainState(step=0, params={"w": zero(3)},
                                  opt_state={"w": zero(3)},
                                  gossip=GossipState(phase=0,
                                                     ps_weight=zero())))
print("STATE " + json.dumps({
    "global": cm.saves_global_state, "root": cm.checkpoint_path,
    "latest": cm.latest_step(), "w": got.params["w"].tolist(),
    "m": got.opt_state["w"].tolist(), "ps": got.gossip.ps_weight.tolist(),
    "step": got.step, "phase": got.gossip.phase, "meta": meta}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def test_two_processes_keep_their_own_rows(tmp_path):
    logs = torchrun(2, lambda r: [sys.executable, "-c", _CHILD, REPO,
                                  str(tmp_path)], timeout=120,
                    PYTHONPATH=REPO)

    def tagged(log, tag):
        line = next(x for x in log.splitlines() if x.startswith(tag + " "))
        return json.loads(line[len(tag) + 1:])

    for r, log in enumerate(logs):
        state = tagged(log, "STATE")
        assert state["global"] and state["latest"] == 1
        assert state["root"] == os.path.join(str(tmp_path), "dcp_global_n2")
        assert state["w"] == [[r + 1.0] * 3]
        assert state["m"] == [[10.0 * (r + 1)] * 3]
        assert state["ps"] == [r + 0.5]
        assert (state["step"], state["phase"]) == (4, 1)
        assert state["meta"]["epoch"] == 1
    assert sorted(os.listdir(tmp_path)) == ["dcp_global_n2"]


def test_the_step_key_follows_the_epoch_or_epoch_id(tmp_path):
    cm = DcpCheckpointManager(str(tmp_path), world_size=WORLD,
                              async_save=False)
    assert cm.save(_state(), {"epoch": 5}).endswith(os.sep + "5")
    assert cm.save(_state(), {"epoch": 5}, epoch_id=12).endswith(
        os.sep + "12")
    # a save at a step already on disk replaces it
    later = dataclasses.replace(_state(seed=3), step=99)
    cm.save(later, {"epoch": 5, "again": True})
    assert cm.latest_step() == 12
    os.rename(os.path.join(cm.checkpoint_path, "12"),
              os.path.join(str(tmp_path), "moved"))
    got, meta = cm.restore(_state())
    assert meta == {"epoch": 5, "again": True} and got.step == 99
