"""AD-PSGD CLI — bilateral gossip training.

Port of ``stochastic_gradient_push_tpu/run/gossip_sgd_adpsgd.py``: the
synchronous formulation of AD-PSGD, where each step every rank averages
its parameters with one partner of a perfect matching
(``algorithms.BilateralGossip``).  ``--num_peers`` sets the bilateral
partners per iteration (the ppi schedule) and the default graph is the
bipartite exponential graph (``--graph_type 1``), as in the reference;
every other flag goes to ``run/gossip_sgd.py``.

``--bilat_async True`` (wall-clock asynchronous averaging on a host
thread, ``train/async_bilat.py``) and its ``--bilat_async_interval`` are
not ported and are refused by name.
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
    peel.add_argument("--bilat_async", default="False", type=str)
    peel.add_argument("--bilat_async_interval", default=0.0, type=float)
    known, rest = peel.parse_known_args(argv)
    if _str_bool(known.bilat_async) or known.bilat_async_interval:
        flag = ("--bilat_async" if _str_bool(known.bilat_async)
                else "--bilat_async_interval")
        raise SystemExit(
            f"{flag}: wall-clock asynchronous AD-PSGD (train/"
            "async_bilat.py) is not ported to stochastic_gradient_push_"
            "torch yet (ROADMAP.md Queue 1 item 8)")
    forwarded = rest + ["--graph_type", str(known.graph_type)]

    def to_bilat(cfg, args):
        cfg.bilat = True
        cfg.ppi_schedule = {0: known.num_peers}
        return cfg

    return base_main(forwarded, config_transform=to_bilat)


if __name__ == "__main__":
    main()
