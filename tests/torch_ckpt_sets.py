"""Helpers for the checkpoint-set tests: a stacked state between the
reference's layout (nested params, the ``{"0": {"0": params, "1": w}}``
FIFO) and the port's (flat names, a list FIFO); bit-for-bit tree
comparison; the reference's reshard of a port set on disk; every tensor
of a DCP checkpoint."""

import numpy as np
import torch

from stochastic_gradient_push_torch.supervise import reshard as port


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def nest(names):
    out = {}
    for name, v in names.items():
        *mods, leaf = name.split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def to_port(state):
    """The reference layout's state in the port's."""
    g = state["gossip"]
    fifo = g["in_flight"] or {}
    out = {"step": state["step"], "params": flat(state["params"]),
           "opt_state": flat(state["opt_state"]),
           "batch_stats": flat(state["batch_stats"]),
           "gossip": {"phase": g["phase"], "ps_weight": g["ps_weight"],
                      "in_flight": [{"params": flat(fifo[k]["0"]),
                                     "ps_weight": fifo[k]["1"]}
                                    for k in sorted(fifo, key=int)]}}
    if "ef_residual" in g:
        out["gossip"]["ef_residual"] = flat(g["ef_residual"])
    return out


def from_port(state):
    """The port's layout back in the reference's."""
    g = state["gossip"]
    out = {"step": state["step"], "params": nest(state["params"]),
           "opt_state": nest(state["opt_state"]),
           "batch_stats": nest(state["batch_stats"]),
           "gossip": {"phase": g["phase"], "ps_weight": g["ps_weight"],
                      "in_flight": {str(k): {"0": nest(s["params"]),
                                             "1": s["ps_weight"]}
                                    for k, s in enumerate(g["in_flight"])}
                      or None}}
    if "ef_residual" in g:
        out["gossip"]["ef_residual"] = nest(g["ef_residual"])
    return out


def assert_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def reference_reshard(directory, tag, old, new):
    """The reference's ``reshard_state`` of the port's ``old``-world set
    in ``directory`` (read by the port's loader), in the reference's
    layout."""
    from stochastic_gradient_push_tpu.supervise import reshard as ref

    state, _, _ = port.load_world_checkpoint(str(directory), tag, old)
    return ref.reshard_state(from_port(state), old, new)


def port_set(directory, tag, world):
    """A port set on disk, stacked, in the reference's layout."""
    return from_port(port.load_world_checkpoint(str(directory), tag,
                                                world)[0])


def dcp_tensors(path):
    """Every tensor of a DCP checkpoint directory, by its flat key."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata()
    out = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
           for k, m in meta.state_dict_metadata.items() if hasattr(m, "size")}
    dcp.load(out, checkpoint_id=str(path), no_dist=True)
    return out
