"""Serve a TransformerLM with continuous batching over paged KV, on the GPU.

Port of the JAX package's ``scripts/serve.py`` (``_print_metrics``,
``_build_engine``, ``serve_dir``, ``selftest``): the same flags, the same
printed ``serve:`` lines and the same artifact keys.  Parameters come
from one of three sources:

* a positional ``run_dir``, a training run's checkpoint set
  (``{tag}checkpoint_r*_n*.ckpt``, ``--tag``, ``--world``) ingested as
  its push-sum consensus (``serve/load.py::load_consensus``); a set whose
  parameters hold no LM (a ResNet run's files) serves through
  ``serve/bench.py::SyntheticEngine``, seeded with the reference's digest
  of its parameters;
* ``--params_npz``, a flat npz whose keys are the ``/``-joined flax leaf
  paths (e.g. ``block_0/attn/q/kernel``);
* ``--init_seed``, a random init at ``--d_model/--n_layers/--d_ff/
  --vocab_size``.

Usage:
    # serve a run's consensus, KV heads split over two shards on the card
    python -m stochastic_gradient_push_torch.serve.cli RUN_DIR --tag lm_ \\
        --n_heads 12 --model_shards 2 --trace_dir /runs/serve1

    # one shard a process (2 processes sharing the card or a card each)
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m stochastic_gradient_push_torch.serve.cli RUN_DIR --tag lm_ \\
        --n_heads 12 --model_shards 2

    # the CI gate: train at world 4 -> ingest (bit-checked against the
    # reshard collapse) -> 2-shard paged decode against the dense model
    # -> 50 requests, zero page leaks
    python -m stochastic_gradient_push_torch.serve.cli --selftest

``--model_shards S`` is the reference's KV-head-sharded decode
(``serve/engine.py``): in one process every shard on the card, under
``torchrun`` with ``S`` processes one shard a process, each process
running the same deterministic scheduler and process 0 alone printing
and writing the artifact.  Runs on ``--device cuda`` (the default; no
card is an error) or ``--device cpu`` (the kernels' plain twins).  Exit
codes: 0 clean, 1 selftest or serve failure, 2 an unusable checkpoint
directory or configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["ARTIFACT_KEYS", "main", "reference_digest"]

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


class _Unusable(Exception):
    """An unusable directory or configuration: exit 2 with this
    message."""


def reference_digest(params: dict) -> int:
    """The reference's ``SyntheticEngine`` seed for a parameter set,
    ``int(Σ|x| · 1000) mod 2**31`` in float64 over its leaves in the
    reference's order and layout: ``params`` (the port's names, as
    ``load_consensus`` returns them) are put in the reference's flatten
    order and kernel layout when a vision model of the port has exactly
    their names (``models/convert.py::reference_layout``), else taken in
    their own order."""
    from ..models.convert import reference_layout
    from ..train.step import MODELS, make_model

    names, order, perms = set(params), list(params), {}
    for name in MODELS:
        model = make_model(name)
        if {n for n, _ in model.named_parameters()} == names:
            layout = reference_layout(model)
            order, perms = list(layout.order), layout.perms
            break
    leaves = []
    for n in order:
        a = np.asarray(params[n], np.float64)
        if n in perms:
            a = np.transpose(a, perms[n])
        leaves.append(a.ravel())
    flat = np.concatenate(leaves) if leaves else np.zeros(1)
    return int(np.abs(flat).sum() * 1000) % (2 ** 31)


def _load_params(args):
    """``(params, info)``: a flax-layout LM tree (or, from a run
    directory, the port-named tensors of a set that holds no LM) and the
    ingest's :class:`~.load.IngestInfo` (None for the other sources)."""
    from ..models.convert import init_params, params_to_jax, unflatten_tree
    from ..models.transformer import TransformerConfig

    if args.run_dir:
        from ..supervise.reshard import CheckpointMetaError, TornCheckpointError
        from .load import ConsensusIngestError, load_consensus

        try:
            params, _, info = load_consensus(args.run_dir, args.tag,
                                             world=args.world)
        except (ConsensusIngestError, TornCheckpointError,
                CheckpointMetaError, FileNotFoundError) as e:
            raise _Unusable(str(e)) from None
        if "embed.weight" in params:
            params = params_to_jax(params)
        return params, info
    if args.params_npz:
        with np.load(args.params_npz) as f:
            return unflatten_tree({k: f[k] for k in f.files}), None
    if not args.n_heads:
        raise _Unusable("--init_seed needs --n_heads")
    if args.d_model % args.n_heads:
        raise _Unusable(f"d_model {args.d_model} not divisible by n_heads "
                        f"{args.n_heads}")
    return init_params(TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff),
        seed=args.init_seed), None


def _launch(args):
    """``(ClusterInfo, device, tp, owns_group)``: one process holding every
    shard, or (under torchrun with ``--model_shards`` processes) one shard
    a process on the default group (``owns_group``: this run joined
    it)."""
    from ..device import resolve_device
    from ..parallel.discovery import discover

    try:
        info = discover()
    except ValueError as e:
        raise _Unusable(str(e)) from None
    if info.world_size == 1:
        return info, resolve_device(args.device), None, False
    if info.world_size != args.model_shards:
        raise _Unusable(f"{info.world_size} processes for --model_shards "
                        f"{args.model_shards}: a process holds one shard")
    if args.rate_hz > 0:
        raise _Unusable("--rate_hz with --model_shards across processes: "
                        "every process runs the same scheduler step by "
                        "step, and an open-loop stream follows each "
                        "process's own clock")
    from ..parallel.collectives import DistTransport
    from ..parallel.multihost import initialize_multihost, process_device
    from ..parallel.tp import DistTp

    import torch.distributed as dist

    device = process_device(args.device, info)
    owns = not dist.is_initialized()
    initialize_multihost("xla", device, info)
    return info, device, DistTp(DistTransport()), owns


def _build_engine(params, args, device, tp):
    """``(engine, vocab)``: the LM engine (sharded when ``--model_shards``
    > 1) for an LM tree, the synthetic digest engine for anything else
    (as the reference, so a set of another model still serves)."""
    from .bench import SyntheticEngine
    from .engine import LMEngine, ServeConfig

    cfg = ServeConfig(
        n_heads=(args.n_heads or 1), page_size=args.page_size,
        num_pages=args.num_pages, max_seqs=args.max_seqs,
        max_pages_per_seq=args.max_pages_per_seq)
    if "embed" not in params:
        return SyntheticEngine(cfg, seed=reference_digest(params)), 256
    if not args.n_heads:
        raise _Unusable("--n_heads is required to serve an LM checkpoint "
                        "(it is not recorded in the params)")
    try:
        engine = LMEngine(params, cfg, device=device,
                          shards=args.model_shards, tp=tp)
    except ValueError as e:
        raise _Unusable(str(e)) from None
    return engine, engine.cfg.vocab_size


def serve(args) -> int:
    from ..ops.flash_attention import flash_fwd
    from ..telemetry import make_run_telemetry
    from .bench import (poisson_arrivals, run_bench, synthetic_requests,
                        write_artifact)
    from .engine import LMEngine
    from .paged_attention import paged_decode

    if args.model_shards < 1:
        raise _Unusable(f"--model_shards {args.model_shards}: must be >= 1")
    info, device, tp, owns_group = _launch(args)
    lead = info.rank == 0
    say = print if lead else (lambda *a, **k: None)
    params, ingest = _load_params(args)
    if ingest is not None:
        say(f"serve: ingested consensus of world {ingest.world} "
            f"({len(ingest.files)} file(s), step {ingest.step}, "
            f"{ingest.in_flight_folded} in-flight slot(s) folded"
            + (", EF residual forfeited" if ingest.ef_forfeited else "")
            + ")", flush=True)
    engine, vocab = _build_engine(params, args, device, tp)
    lm = isinstance(engine, LMEngine)
    if lm:
        c = engine.cfg
        lane = ("" if engine.shards == 1 else
                f", {engine.shards} KV-head shards "
                + ("stacked" if tp is None else
                   f"one a process (shard {info.rank})"))
        say(f"serve: model d{c.d_model} L{c.n_layers} h{c.n_heads} "
            f"ff{c.d_ff} vocab {c.vocab_size} on {engine.device}{lane}",
            flush=True)
    else:
        say(f"serve: no LM in the set; synthetic engine (seed "
            f"{engine.seed})", flush=True)
    requests = synthetic_requests(
        args.requests, seed=args.seed, vocab=min(vocab, 256),
        prompt_tokens=(args.min_prompt, args.max_prompt),
        new_tokens=(args.min_new, args.max_new))
    arrivals = (poisson_arrivals(args.requests, args.rate_hz, args.seed)
                if args.rate_hz > 0 else None)
    rt = make_run_telemetry(args.trace_dir if lead else None, rank=0)
    if rt.registry is not None:
        source = (ingest.to_dict() if ingest is not None else
                  {"params_npz": args.params_npz} if args.params_npz
                  else {"init_seed": args.init_seed})
        rt.registry.emit("run_meta", {
            "algorithm": "serve",
            "world": ingest.world if ingest is not None else 1,
            "serve": True, "model_shards": args.model_shards,
            "model_source": source})
    flash_fwd.launches = paged_decode.launches = 0
    metrics, _ = run_bench(engine, requests, arrivals=arrivals,
                           tracer=rt.tracer, registry=rt.registry)
    rt.finish()
    if tp is not None:
        from ..parallel.multihost import leave

        # every process ends its run here; leave together
        leave(tp.transport, owns_group)
    if lm:
        print(f"serve: kernel launches flash_fwd {flash_fwd.launches}, "
              f"paged_decode {paged_decode.launches}"
              + ("" if lead else f" (process {info.rank})"), flush=True)
    if not lead:
        return 0
    _print_metrics(metrics)
    extra = {"device": str(device), "model_shards": args.model_shards}
    if ingest is not None:
        extra["ingest"] = ingest.to_dict()
    path = write_artifact(args.artifact, metrics, tracer=rt.tracer,
                          extra=extra)
    print(f"serve: artifact -> {path}", flush=True)
    return 0


# -- selftest ---------------------------------------------------------------


def selftest(device=None) -> int:
    """The CI gate on the port's own pieces: a tiny LM trained with
    push-sum gossip at world 4 stacked, its consensus ingested bit-equal
    to the reshard collapse, the 2-shard paged decode against the plain
    oracle and the 2-shard engine's greedy continuation against the dense
    model, then 50 requests through it with zero page leaks."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch

    from ..device import resolve_device
    from ..models.convert import config_from_params, params_from_jax, \
        params_to_jax
    from ..models.transformer import TransformerLM
    from ..ops.flash_attention import flash_fwd
    from ..run import gossip_lm
    from ..supervise.reshard import load_world_checkpoint, reshard_state
    from ..telemetry import make_run_telemetry
    from .bench import run_bench, synthetic_requests, write_artifact
    from .engine import LMEngine, ServeConfig
    from .load import load_consensus
    from .paged_attention import (paged_attention_reference, paged_decode,
                                  sharded_paged_decode)

    dev = resolve_device(device)
    ok = True

    def expect(cond, what):
        nonlocal ok
        if not cond:
            ok = False
            print(f"FAIL: {what}", flush=True)

    # head_dim 64: the paged kernel's width on the card
    WORLD, BATCH, SEQ, VOCAB, HEADS, D = 4, 2, 16, 64, 2, 128
    STEPS, SHARDS = 8, 2
    flash_fwd.launches = paged_decode.launches = 0
    with tempfile.TemporaryDirectory() as d:
        # 1. train a tiny LM with push-sum gossip at world 4 stacked
        argv = ["--device", str(dev), "--world_size", str(WORLD),
                "--vocab_size", str(VOCAB), "--d_model", str(D),
                "--n_layers", "2", "--n_heads", str(HEADS), "--d_ff", "256",
                "--seq_len", str(SEQ), "--batch_size", str(BATCH),
                "--num_steps", str(STEPS), "--attn", "full",
                "--print_freq", str(STEPS), "--checkpoint_dir", d]
        with contextlib.redirect_stdout(io.StringIO()):
            result = gossip_lm.main(argv)
        loss = result["final_loss"]
        expect(np.isfinite(loss), f"train loss not finite: {loss}")
        print(f"serve selftest: trained world {WORLD} for {STEPS} steps "
              f"(loss {loss:.3f})", flush=True)

        # 2. the ingest: bit-equal to the reshard collapse
        state, _, _ = load_world_checkpoint(d, "lm_", WORLD)
        want = reshard_state(state, WORLD, 1)["params"]
        params, _, info = load_consensus(d, tag="lm_")
        expect(info.world == WORLD, f"ingest world {info.world}")
        for n, t in params.items():
            if not np.array_equal(t.numpy(), np.asarray(want[n])[0]):
                expect(False, f"ingest {n} != reshard collapse")
        print("serve selftest: consensus ingest bit-equal to "
              "reshard_state collapse", flush=True)

        # 3. the 2-shard paged decode against the plain oracle, and the
        #    2-shard engine's greedy continuation against the dense model
        r = np.random.default_rng(1)
        q = torch.from_numpy(r.standard_normal((4, 4, 64)).astype(
            np.float32)).to(dev)
        kp, vp = (torch.from_numpy(r.standard_normal(
            (4, 7, 4, 64)).astype(np.float32)).to(dev) for _ in range(2))
        pi = torch.from_numpy(r.integers(0, 7, size=(4, 6)).astype(
            np.int32)).to(dev)
        lengths = torch.tensor([1, 9, 16, 24], dtype=torch.int32,
                               device=dev)
        out = sharded_paged_decode(q, kp, vp, pi, lengths, SHARDS)
        err = float((out - paged_attention_reference(
            q, kp, vp, pi, lengths)).abs().max())
        expect(err < 1e-5, f"sharded paged decode vs dense reference: "
                           f"{err}")
        print(f"serve selftest: paged decode over {SHARDS} KV-head shards "
              f"on {dev}, max err {err:.2e}", flush=True)

        tree = params_to_jax(params)
        engine = LMEngine(tree, ServeConfig(
            n_heads=HEADS, page_size=4, num_pages=32, max_seqs=4,
            max_pages_per_seq=4), device=dev, shards=SHARDS)
        prompt, n_new = [5, 17, 3, 29], 5
        slot, tok = engine.start(list(prompt), len(prompt) + n_new)
        got = [tok]
        while len(got) < n_new:
            got.append(engine.step([slot])[slot])
        engine.finish(slot)
        engine.pages.assert_quiescent()
        dense = TransformerLM(dataclasses.replace(
            config_from_params(tree, HEADS), attn_impl="full"))
        dense.load_state_dict(params_from_jax(tree))
        dense.to(dev).eval()
        seq, want_toks = list(prompt), []
        with torch.no_grad():
            for _ in range(n_new):
                logits = dense(torch.tensor([seq], device=dev))
                want_toks.append(int(torch.argmax(logits[0, -1])))
                seq.append(want_toks[-1])
        expect(got == want_toks,
               f"paged greedy decode {got} != dense model {want_toks}")
        print(f"serve selftest: {SHARDS}-shard engine greedy continuation "
              f"matches the dense model: {got}", flush=True)

        # 4. 50 requests through the engine: all complete, zero page leaks
        #    (run_bench asserts quiescence), the artifact's keys
        N_REQ = 50
        rt = make_run_telemetry(os.path.join(d, "trace"), rank=0)
        rt.registry.emit("run_meta", {
            "algorithm": "serve", "world": WORLD, "serve": True,
            "model_source": info.to_dict()})
        requests = synthetic_requests(N_REQ, seed=9, vocab=VOCAB,
                                      prompt_tokens=(2, 6),
                                      new_tokens=(2, 5))
        metrics, completions = run_bench(
            engine, requests, tracer=rt.tracer, registry=rt.registry)
        rt.finish()
        expect(metrics["requests"] == N_REQ,
               f"{metrics['requests']}/{N_REQ} requests completed")
        expect(metrics["admission_rejections"] == 0,
               f"{metrics['admission_rejections']} unexpected rejections")
        expect(all(len(c.tokens) == requests[c.rid].max_new_tokens
                   for c in completions), "token budgets not honored")
        expect(metrics["kv_bytes_per_token"]
               == engine.kv_bytes_per_token() > 0,
               f"kv bytes/token {metrics['kv_bytes_per_token']}")
        path = write_artifact(os.path.join(d, "bench_serve.json"), metrics,
                              tracer=rt.tracer,
                              extra={"ingest": info.to_dict()})
        with open(path) as f:
            doc = json.load(f)
        expect(set(doc) == {"bench", "trace"},
               f"artifact layout: {sorted(doc)}")
        missing = ARTIFACT_KEYS - set(doc.get("bench", {}))
        expect(not missing, f"artifact missing keys: {sorted(missing)}")
        b = doc.get("bench", {})
        expect(b.get("tokens_per_sec", 0) > 0, "tokens/sec not stamped")
        expect(b.get("p99_latency_s", 0) >= b.get("p50_latency_s", 1),
               "p99 < p50")
        _print_metrics(metrics)
    print(f"serve selftest: kernel launches flash_fwd {flash_fwd.launches}, "
          f"paged_decode {paged_decode.launches}", flush=True)
    print("serve selftest:", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


# -- entry ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?",
                   help="checkpoint directory ({tag}checkpoint_r*_n*.ckpt)")
    p.add_argument("--tag", default="")
    p.add_argument("--world", type=int, default=None,
                   help="checkpoint world to ingest (default: newest)")
    p.add_argument("--params_npz", default=None,
                   help="flat npz of '/'-joined flax leaf paths")
    p.add_argument("--init_seed", type=int, default=None,
                   help="random init from this seed at the --d_model/"
                        "--n_layers/--d_ff/--vocab_size shape")
    p.add_argument("--n_heads", type=int, default=None,
                   help="attention heads of the LM (required for LM sets: "
                        "not recorded in the params)")
    p.add_argument("--model_shards", type=int, default=1,
                   help="KV-head shards: stacked in one process, or one a "
                        "process under torchrun")
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
    p.add_argument("--trace_dir", default=None,
                   help="events.jsonl + trace.json output directory")
    p.add_argument("--artifact",
                   default=os.path.join("artifacts", "bench_serve.json"))
    p.add_argument("--selftest", action="store_true",
                   help="train -> ingest -> serve CI gate")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    sources = [s for s, v in (("run_dir", args.run_dir),
                              ("--params_npz", args.params_npz),
                              ("--init_seed", args.init_seed))
               if v is not None]
    if len(sources) != 1:
        p.error("one of run_dir, --params_npz or --init_seed is required "
                f"(or --selftest); got {sources or 'none'}")
    try:
        return serve(args)
    except _Unusable as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
