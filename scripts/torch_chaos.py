#!/usr/bin/env python
"""torch_chaos — gossip fault injection on the port: describe plans, run
the chaos drill.

Usage:
    python scripts/torch_chaos.py --selftest                # on the card
    python scripts/torch_chaos.py --selftest --device cpu   # on the CPU
    python scripts/torch_chaos.py --describe 'drop:0->1@0:64' --topology ring
    python scripts/torch_chaos.py --describe 'straggler:3@10:20;seed:7' \\
        --topology npeer-exponential --world 16

Exit codes: 0 clean, 1 selftest failure, 2 unsupported configuration.

The selftest is the resilience acceptance loop at world 8, stacked on
one device: a dropped gossip edge keeps the network-wide parameter mean
to float32 tolerance (mass-conserving drop semantics), the runtime
monitor reports the residual excursion in a structured ``gossip
health:`` line, and recovery brings consensus below the floor within
one global-average cycle.  On the card its rounds run the CUDA K2/K1
(``csrc/gossip_edge.cu``); see
``stochastic_gradient_push_torch/resilience/chaos.py``.
"""

import os
import signal
import sys

# die quietly when piped into `head` instead of tracebacking
signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stochastic_gradient_push_torch.resilience.chaos import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
