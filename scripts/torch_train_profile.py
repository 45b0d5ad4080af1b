#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's LM training step, on one GPU.

    python3 scripts/torch_train_profile.py [--steps 5] [--out PATH]

Builds the training main path of ``chip_smoke.py`` (the d768/L12/h12/
ff3072/vocab32000 LM, T1024, B8, fp32 with TF32 off; SGP at world 1;
``attn_impl="flash"``; random weights and tokens from seed 0), takes two
warm-up steps, then measures ``--steps`` steps from one state: the
host-clock mean per step, then the same steps under ``torch.profiler``:
device time by kernel, the device's busy share of the window (kernel
time / window wall time) and the flash kernels' share of the device
time.  Prints one JSON object (also written to ``--out``) with the
card's name and power limit.  Needs a CUDA card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=os.path.join(
        "artifacts", "torch_train_profile.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import _train_setup
    from stochastic_gradient_push_torch.train.lm import init_lm_state
    from torch_serve_profile import _device_kernels, _window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg, alg, tx, step = _train_setup("flash")
    state = init_lm_state(cfg, alg, tx, 1, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks, tgts = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, 8, 1024))).cuda() for _ in range(2))
    for _ in range(2):
        step(state, toks, tgts)
    window = _window(lambda: step(state, toks, tgts), args.steps)

    # the flash kernels' share of the device time, from a second window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, toks, tgts)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    total = sum(kernels.values())
    flash = {n: us for n, us in kernels.items() if "flash_" in n}
    window["flash_kernels_ms_per_step"] = {
        n[:90]: us / 1e3 / args.steps for n, us in flash.items()}
    window["flash_share_of_device_time"] = sum(flash.values()) / total
    window["tokens_per_sec_host_clock"] = (
        8 * 1024 / (window["host_ms_per_call"] / 1e3))
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "train_step_t1024_b8": window}
    out = json.dumps(result, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
