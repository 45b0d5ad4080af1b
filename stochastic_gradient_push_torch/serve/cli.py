"""Serve a TransformerLM with continuous batching over paged KV, on the GPU.

The serving half of the JAX package's ``scripts/serve.py``
(``_print_metrics``, ``_build_engine``, ``serve_dir``): the same flags,
the same printed ``serve:`` lines and the same artifact keys.  Parameters
come from ``--params_npz`` (a flat npz whose keys are the ``/``-joined
flax leaf paths, e.g. ``block_0/attn/q/kernel``) or are made from
``--init_seed`` at ``--d_model/--n_layers/--d_ff/--vocab_size``.

Usage:
    python -m stochastic_gradient_push_torch.serve.cli --init_seed 0 \\
        --n_heads 12 --d_model 768 --n_layers 12 --d_ff 3072 \\
        --page_size 16 --num_pages 1024 --max_seqs 16 \\
        --max_pages_per_seq 48 --requests 48 --min_prompt 64 \\
        --max_prompt 512 --min_new 16 --max_new 128

Runs on ``--device cuda`` (the default; no card is an error) or
``--device cpu`` (the kernels' plain twins).  Exit codes: 0 clean, 2 an
unusable configuration.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ["ARTIFACT_KEYS", "main"]

# every bench/report consumer expects this key set in the artifact
ARTIFACT_KEYS = frozenset({
    "requests", "tokens", "elapsed_s", "tokens_per_sec",
    "p50_latency_s", "p99_latency_s", "page_occupancy_peak",
    "admission_rejections", "kv_bytes_per_token", "decode_steps"})


def _print_metrics(metrics: dict) -> None:
    print(f"serve: {metrics['requests']} request(s), "
          f"{metrics['tokens']} token(s), "
          f"{metrics['tokens_per_sec']:.1f} tok/s, latency p50 "
          f"{metrics['p50_latency_s'] * 1e3:.2f} ms  p99 "
          f"{metrics['p99_latency_s'] * 1e3:.2f} ms", flush=True)
    print(f"serve: peak page occupancy "
          f"{metrics['page_occupancy_peak']:.0%}, "
          f"{metrics['admission_rejections']} admission rejection(s), "
          f"kv {metrics['kv_bytes_per_token']:,} B/token, "
          f"{metrics['decode_steps']} decode step(s)", flush=True)


def _load_params(args):
    from ..models.convert import init_params, unflatten_tree
    from ..models.transformer import TransformerConfig

    if args.params_npz:
        with np.load(args.params_npz) as f:
            return unflatten_tree({k: f[k] for k in f.files})
    return init_params(TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff),
        seed=args.init_seed)


def _build_engine(params, args):
    from .engine import LMEngine, ServeConfig

    cfg = ServeConfig(
        n_heads=args.n_heads, page_size=args.page_size,
        num_pages=args.num_pages, max_seqs=args.max_seqs,
        max_pages_per_seq=args.max_pages_per_seq)
    engine = LMEngine(params, cfg, device=args.device)
    return engine, engine.cfg.vocab_size


def serve(args) -> int:
    from ..ops.flash_attention import flash_fwd
    from .bench import (poisson_arrivals, run_bench, synthetic_requests,
                        write_artifact)
    from .paged_attention import paged_decode

    engine, vocab = _build_engine(_load_params(args), args)
    c = engine.cfg
    print(f"serve: model d{c.d_model} L{c.n_layers} h{c.n_heads} "
          f"ff{c.d_ff} vocab {c.vocab_size} on {engine.device}",
          flush=True)
    requests = synthetic_requests(
        args.requests, seed=args.seed, vocab=min(vocab, 256),
        prompt_tokens=(args.min_prompt, args.max_prompt),
        new_tokens=(args.min_new, args.max_new))
    arrivals = (poisson_arrivals(args.requests, args.rate_hz, args.seed)
                if args.rate_hz > 0 else None)
    flash_fwd.launches = paged_decode.launches = 0
    metrics, _ = run_bench(engine, requests, arrivals=arrivals)
    _print_metrics(metrics)
    print(f"serve: kernel launches flash_fwd {flash_fwd.launches}, "
          f"paged_decode {paged_decode.launches}", flush=True)
    path = write_artifact(args.artifact, metrics,
                          extra={"device": str(engine.device)})
    print(f"serve: artifact -> {path}", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params_npz", default=None,
                     help="flat npz of '/'-joined flax leaf paths")
    src.add_argument("--init_seed", type=int, default=None,
                     help="random init from this seed at the --d_model/"
                          "--n_layers/--d_ff/--vocab_size shape")
    p.add_argument("--n_heads", type=int, required=True,
                   help="attention heads (not recorded in the params)")
    p.add_argument("--d_model", type=int, default=768)
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--d_ff", type=int, default=3072)
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--page_size", type=int, default=8)
    p.add_argument("--num_pages", type=int, default=64)
    p.add_argument("--max_seqs", type=int, default=4)
    p.add_argument("--max_pages_per_seq", type=int, default=8)
    p.add_argument("--requests", type=int, default=100)
    p.add_argument("--rate_hz", type=float, default=0.0,
                   help="Poisson arrival rate (0 = closed loop)")
    p.add_argument("--min_prompt", type=int, default=4)
    p.add_argument("--max_prompt", type=int, default=12)
    p.add_argument("--min_new", type=int, default=2)
    p.add_argument("--max_new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--artifact",
                   default=os.path.join("artifacts", "bench_serve.json"))
    args = p.parse_args(argv)
    if args.init_seed is not None and args.d_model % args.n_heads:
        print(f"error: d_model {args.d_model} not divisible by n_heads "
              f"{args.n_heads}", file=sys.stderr)
        return 2
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
