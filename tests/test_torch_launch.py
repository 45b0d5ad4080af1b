"""The test launcher (``tests/torch_launch.py``): the rendezvous port is
held by the test's process for as long as its children run, so no other
process can take it between the pick and rank 0's start, and children
started with a ``tcp://`` address or under a torchrun environment join
that store as clients."""

import socket
import sys

import pytest

from torch_launch import Rendezvous, spawn, torchrun

_CHILD = r"""
import sys
import torch
import torch.distributed as dist
if len(sys.argv) > 1:
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
else:
    dist.init_process_group("gloo")
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
print(f"rank {dist.get_rank()} sum {x.item()}", flush=True)
dist.destroy_process_group()
"""


def test_the_rendezvous_holds_its_port():
    rdv = Rendezvous()
    with socket.socket() as s, pytest.raises(OSError):
        s.bind(("127.0.0.1", rdv.port))
    env = rdv.env(1, 2)
    assert (env["MASTER_PORT"], env["RANK"], env["WORLD_SIZE"]) == (
        str(rdv.port), "1", "2")
    assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"


@pytest.mark.parametrize("how", ["tcp", "torchrun"])
def test_children_join_the_held_store(how):
    if how == "tcp":
        logs = spawn(2, lambda r, port: [sys.executable, "-c", _CHILD,
                                         str(r), str(port)], timeout=120)
    else:
        logs = torchrun(2, lambda r: [sys.executable, "-c", _CHILD],
                        timeout=120)
    for r, log in enumerate(logs):
        assert f"rank {r} sum 3.0" in log, log
