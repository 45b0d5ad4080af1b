"""AD-PSGD CLI — bilateral gossip training.

Port of ``stochastic_gradient_push_tpu/run/gossip_sgd_adpsgd.py``: the
synchronous formulation of AD-PSGD, where each step every rank averages
its parameters with one partner of a perfect matching
(``algorithms.BilateralGossip``).  ``--num_peers`` sets the bilateral
partners per iteration (the ppi schedule) and the default graph is the
bipartite exponential graph (``--graph_type 1``), as in the reference;
every other flag goes to ``run/gossip_sgd.py``.

``--bilat_async True`` is the paper's asynchronous form: the step
carries no communication and a host thread averages bilaterally off the
step, its displacements adopted with a wall-clock staleness
(``train/async_bilat.py``); ``--bilat_async_interval`` paces its rounds
(seconds, 0 unpaced).  The staleness summary is logged at the end of the
run and returned in the result (``async_bilat``).  It is single-process
only, and refused under torchrun.
"""

from __future__ import annotations

import argparse

from .gossip_sgd import _str_bool
from .gossip_sgd import main as base_main

__all__ = ["main"]


def main(argv=None):
    # peel off the AD-PSGD flags, forward the rest
    peel = argparse.ArgumentParser(add_help=False)
    peel.add_argument("--num_peers", default=1, type=int)
    peel.add_argument("--graph_type", default=1, type=int)
    peel.add_argument("--bilat_async", default="False", type=str,
                      help="True: bilateral averaging on a host thread off "
                           "the step (train/async_bilat.py), adopted with "
                           "a wall-clock staleness")
    peel.add_argument("--bilat_async_interval", default=0.0, type=float,
                      help="least seconds between host averaging rounds "
                           "(0 = unpaced); raising it widens staleness")
    known, rest = peel.parse_known_args(argv)
    forwarded = rest + ["--graph_type", str(known.graph_type)]

    def to_bilat(cfg, args):
        cfg.bilat = True
        cfg.bilat_async = _str_bool(known.bilat_async)
        cfg.bilat_async_interval = known.bilat_async_interval
        cfg.ppi_schedule = {0: known.num_peers}
        return cfg

    return base_main(forwarded, config_transform=to_bilat)


if __name__ == "__main__":
    main()
