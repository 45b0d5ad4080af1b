#!/usr/bin/env python
"""torch_wirecheck — the quantized gossip wire's selftest, on the port.

Usage:
    python scripts/torch_wirecheck.py --selftest [--device cpu|cuda]

Exit codes: 0 clean, 1 selftest failure.

Four stages on the stacked lane at world 8
(``stochastic_gradient_push_torch/parallel/wirecheck.py``): an int8 +
error-feedback chaos round under a dropped edge keeps the network mean
with the push-sum weight lane exact and ``ef_residual_rms`` bounded;
int8 + EF consensus within 2x of the exact f32 wire; the ``CommModel``
pricing of the encoded payload against a hand count; the chaos round on
the gossip kernel lane (the CUDA K2/K1 on the card, their twins on the
CPU), its ps-weight trajectory bit-identical to the plain lane's.  The
default device is the card when there is one, else the CPU.
"""

import os
import signal
import sys

# die quietly when piped into `head` instead of tracebacking
signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stochastic_gradient_push_torch.parallel.wirecheck import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
