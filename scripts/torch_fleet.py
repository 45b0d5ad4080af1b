#!/usr/bin/env python
"""torch_fleet — two-level fleet supervision over the port: per-host
supervisors + a pod coordinator that survive whole-host loss.

Usage:
    # the pod coordinator (one per fleet, shared filesystem):
    python scripts/torch_fleet.py --coordinator --fleet_dir /runs/f1 \\
        --hosts 4 --rows 1

    # one per-host supervisor (everything after -- is that host's
    # training command; one gossip rank a process, so a host of the
    # real CLI owns one row):
    python scripts/torch_fleet.py --host 2 --fleet_dir /runs/f1 --rows 1 -- \\
        python -m stochastic_gradient_push_torch.run.gossip_sgd \\
        --world_size 4 --multihost True --num_processes 4 --process_id 2 \\
        --coordinator_address 127.0.0.1:29500 --fleet True \\
        --checkpoint_dir /runs/f1 --trace_dir /runs/f1/host2 ...

    # the chaos e2e (SIGKILL a whole simulated host mid-run -> rendezvous
    # excludes it -> concurrent 6->4 reshard -> one coordinated relaunch
    # -> run completes at the shrunken world; numpy children, no card):
    python scripts/torch_fleet.py --selftest

Exit codes: 0 clean, 1 selftest failure / fleet gave up, 75
preempted-after-checkpoint (requeue me), 2 unusable configuration,
4 this host was excluded from the new world.

The coordinator tails every host's supervisor.jsonl and broadcasts
rendezvous calls and fleet decisions through coordinator.jsonl; see
stochastic_gradient_push_torch/supervise/coordinator.py.
"""

import os
import signal
import sys

# die quietly when piped into `head` instead of tracebacking
signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stochastic_gradient_push_torch.supervise.fleetcli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
