#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

    python3 scripts/torch_serve_profile.py [--ticks 20] [--out PATH]

Builds the port's ``LMEngine`` at the d768/L12/h12/ff3072/vocab32000
shape (random weights from seed 0; ``ServeConfig(n_heads=12,
page_size=16, num_pages=1024, max_seqs=16, max_pages_per_seq=48)``, as
``chip_smoke.py``), fills all 16 slots with prompts from
``synthetic_requests(16, seed=0, vocab=256, prompt_tokens=(64, 512))``,
and measures:

* the decode tick: host-clock mean over ``--ticks`` full-batch ticks
  (each ends in a device-to-host read of the argmax), then the same
  window under ``torch.profiler``: device time by kernel, the device's
  busy share of the window (kernel time / window wall time);
* one prefill of a 512-token prompt the same two ways.

Prints one JSON object (also written to ``--out``) with the card's name
and power limit.  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_kernels(prof) -> dict[str, float]:
    """Device-side events of a profile: name -> total microseconds."""
    import torch

    out = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] += ev.time_range.elapsed_us()
    if not out:
        raise RuntimeError("torch.profiler recorded no device events")
    return dict(out)


def _window(fn, n: int) -> dict:
    """Host-clock mean of ``fn`` over ``n`` calls, then the same calls
    under the profiler: busy share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "calls": n,
        "host_ms_per_call": host_ms,
        "profiled_ms_per_call": wall_us / 1e3 / n,
        "device_ms_per_call": busy_us / 1e3 / n,
        "device_busy_share": busy_us / wall_us,
        "top_kernels_ms_per_call": {name[:90]: us / 1e3 / n
                                    for name, us in top},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--out", default=os.path.join(
        "artifacts", "torch_serve_profile.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stochastic_gradient_push_torch.models.convert import init_params
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.serve.bench import (
        synthetic_requests)
    from stochastic_gradient_push_torch.serve.engine import (
        LMEngine, ServeConfig)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg = TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                            n_heads=12, d_ff=3072)
    engine = LMEngine(init_params(cfg, seed=0), ServeConfig(
        n_heads=12, page_size=16, num_pages=1024, max_seqs=16,
        max_pages_per_seq=48), device="cuda")
    requests = synthetic_requests(16, seed=0, vocab=256,
                                  prompt_tokens=(64, 512),
                                  new_tokens=(128, 128))
    slots = [engine.start(list(r.prompt), len(r.prompt) + 256)[0]
             for r in requests]
    mean_ctx = sum(engine.pages.length(s) for s in slots) / len(slots)
    for _ in range(5):
        engine.step(slots)
    decode = _window(lambda: engine.step(slots), args.ticks)
    decode["mean_context_tokens_at_start"] = mean_ctx
    for s in slots:
        engine.finish(s)

    prompt = list(range(1, 513))

    def one_prefill():
        slot, _ = engine.start(prompt, len(prompt) + 1)
        engine.finish(slot)

    one_prefill()
    prefill = _window(one_prefill, 5)
    prefill["prompt_tokens"] = len(prompt)
    result = {"card": smi, "torch": torch.__version__,
              "decode_tick_batch16": decode, "prefill_t512": prefill}
    out = json.dumps(result, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
