#!/usr/bin/env python3
"""Time the port's flash and paged-decode kernels, for one tree.

    python3 scripts/torch_kernel_times.py [--root DIR]

Runs ``chip_smoke.py``'s ``check_flash``, ``check_paged`` and
``check_flash_bwd`` on the ``stochastic_gradient_push_torch`` package
found under ``--root`` (default: this checkout), with this checkout's
timers and bounds, and, for a tree with the bf16 forms of the flash
kernels, ``check_flash_bf16`` at B8 H12 T1024 causal and at the ring
tick's shape (b2 h12 t1024, causal and full); prints their lines and one
``KERNELS {...}`` JSON line.  To compare two commits on one card, unpack
the other into a git-ignored directory (``git archive <rev> | tar -x -C
build/parent``) and run both in one call, in turns (parent, this, this,
parent), each in its own process.  A tree that fails ``-Xptxas -v``'s spill check is still
timed, so an older kernel can be measured, and its ``KERNELS`` line says
so under ``"ptxas"``.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding the package to time")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from stochastic_gradient_push_torch.ops import _build

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"tree {root} [{card}]", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    try:
        smoke.report_ptxas(built)
        ptxas = "ok"
    except AssertionError as err:
        ptxas = f"FAILED, timed all the same: {err}"
        print(f"ptxas spill check {ptxas}", flush=True)
    rows = {phase: getattr(smoke, phase)(card) for phase in (
        "check_flash", "check_paged", "check_flash_bwd")}
    from stochastic_gradient_push_torch.ops import flash_attention

    if torch.bfloat16 in getattr(flash_attention, "FORMS", {}):
        rows["check_flash_bf16"] = smoke.check_flash_bf16(
            card, ((8, 1024, True), (2, 1024, True), (2, 1024, False)),
            row_case=(8, 1024, True))
    print("KERNELS " + json.dumps({"tree": root, "card": card,
                                   "ptxas": ptxas, **rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
