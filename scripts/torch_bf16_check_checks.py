#!/usr/bin/env python3
"""Show that phase 12's bf16 checks fail a kernel that rounds P and dS once.

    python3 scripts/torch_bf16_check_checks.py

The bf16 flash kernels feed P (K3, K5) and dS (K4, K5) to their second
products as hi/lo bf16 pairs (``csrc/bf16_mma.cuh::split``).  This script
runs ``chip_smoke.py``'s phase-12 checks twice, each in its own process:
on this checkout, where all must pass, and on a copy of the port under
``build/check_checks/`` whose ``split`` sets ``lo = 0`` (P and dS rounded
once to bf16, the kernels' first design), where 12d (the kernels against
their plain versions at B8 H12 T1024 causal), 12a (world 1, ``flash``)
and 12b (dp 2 x sp 4, ``ring_flash``) must each fail.  It prints every
check's lines and one ``CHECKS {...}`` JSON line, and exits 0 only when
both come out so.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = "  lo = pack(x0 - lo_f(hi), x1 - hi_f(hi));"
CHECKS = ("12d", "12a", "12b")


def run_checks(root: str) -> dict:
    """Phase 12's checks on the tree at ``root``, in this process: each
    check's outcome, going on past a failed one."""
    sys.path.insert(0, root)
    import chip_smoke as smoke
    import torch

    from stochastic_gradient_push_torch.ops import _build

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"tree {root} [{card}]", flush=True)
    _build.build()
    nan = {"ms": math.nan, "tokens_per_s": math.nan, "peak_gb": math.nan}
    phases = {
        "12d": lambda: smoke.check_flash_bf16(card, ((8, 1024, True),)),
        "12a": lambda: smoke.bf16_train_path(card, nan),
        "12b": lambda: smoke.bf16_seq_path(card, nan)}
    outcome = {}
    for name, phase in phases.items():
        try:
            phase()
            outcome[name] = "passed"
        except AssertionError as err:
            outcome[name] = "failed"
            print(f"{name} failed: {err}", flush=True)
        torch.cuda.empty_cache()
    return outcome


def mutant() -> str:
    """A copy of the port whose bf16 kernels round P and dS once."""
    root = os.path.join(HERE, "build", "check_checks")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    shutil.copytree(os.path.join(HERE, "stochastic_gradient_push_torch"),
                    os.path.join(root, "stochastic_gradient_push_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = os.path.join(root, "stochastic_gradient_push_torch", "csrc",
                       "bf16_mma.cuh")
    with open(cuh) as f:
        src = f.read()
    if src.count(SPLIT) != 1:
        raise SystemExit(f"{cuh}: the hi/lo split is not where expected")
    with open(cuh, "w") as f:
        f.write(src.replace(SPLIT, "  lo = 0u;"))
    return root


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print("OUTCOME " + json.dumps(run_checks(sys.argv[2])), flush=True)
        return 0
    trees = {"hi/lo pairs": HERE, "rounded once": mutant()}
    result = {}
    for label, root in trees.items():
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", root], stdout=subprocess.PIPE,
                              text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(f"[{label}] {line}" for line in lines), flush=True)
        found = [json.loads(line.split(" ", 1)[1]) for line in lines
                 if line.startswith("OUTCOME ")]
        result[label] = found[0] if proc.returncode == 0 and found else {
            "exit": proc.returncode}
    shutil.rmtree(trees["rounded once"], ignore_errors=True)
    print("CHECKS " + json.dumps(result), flush=True)
    ok = (result["hi/lo pairs"] == dict.fromkeys(CHECKS, "passed")
          and result["rounded once"] == dict.fromkeys(CHECKS, "failed"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
