#!/usr/bin/env python
"""torch_supervise — elastic run supervisor over the port's CLIs:
checkpoint, reshard, replan, relaunch.

Usage:
    # supervise a training run (everything after -- is the child):
    python scripts/torch_supervise.py -- \\
        python -m stochastic_gradient_push_torch.run.gossip_sgd \\
        --world_size 8 --trace_dir /runs/t1 --checkpoint_dir /runs/t1 ...

    # the chaos e2e (kill a world-8 run after its first checkpoint set ->
    # reshard 8->4 -> relaunch), on the card, or on the CPU:
    python scripts/torch_supervise.py --selftest [--device cpu]

Exit codes: 0 run complete, 1 selftest failure / restart budget spent,
75 preempted-after-checkpoint (requeue me), 2 unusable configuration.

The supervisor tails the child's typed events.jsonl stream and acts on
rank loss, sustained re-plan suggestions, watchdog stalls, crashes, and
preemption signals; see stochastic_gradient_push_torch/supervise/.
"""

import os
import signal
import sys

# die quietly when piped into `head` instead of tracebacking
signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stochastic_gradient_push_torch.supervise.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
