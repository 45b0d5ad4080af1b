#!/usr/bin/env python
"""torch_sim — priced-fabric fleet simulator for gossip + supervision, on
the port.

Executes compiled gossip schedules EXACTLY (the engine's scatter is
bit-identical to the dense mixing-matrix oracle, and to the reference's
engine) over thousands of ranks, prices every message on the planner's
interconnect model, runs fault campaigns through the resilience
grammar's mass-conserving masks, and drives the port's supervise/
coordinator against simulated hosts.  numpy and threads on the host, no
device.

Usage:
    # a consensus-vs-simulated-wall-clock curve on a sliced fabric:
    python scripts/torch_sim.py --topology exponential --world 1024 \\
        --slice-size 256 --steps 200 --out curve.json

    # a named fault campaign over the run:
    python scripts/torch_sim.py --world 1024 --slice-size 128 \\
        --campaign kill-slice

    # the gate: engine bit-exactness at world 256, priced
    # ring-vs-exponential ordering, churn mass conservation, and the
    # kill-slice / coordinator-loss / grow fleet scenarios against the
    # real coordinator:
    python scripts/torch_sim.py --selftest

Exit codes: 0 clean, 1 selftest failure.
"""

import os
import signal
import sys

# die quietly when piped into `head` instead of tracebacking
signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from stochastic_gradient_push_torch.sim.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
