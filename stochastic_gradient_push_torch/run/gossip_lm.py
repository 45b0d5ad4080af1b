"""Gossip LM CLI — decentralized transformer training on the GPU.

Port of ``stochastic_gradient_push_tpu/run/gossip_lm.py`` for the flat
data-parallel mesh and the ``(gossip, seq)`` mesh: SGP or OSGP
(push-sum over a flat gossip graph), D-PSGD (``--push_sum False``),
AD-PSGD (``--bilat True``, bilateral averaging over the graph's perfect
matchings) or AllReduce, the synthetic Markov corpus, torch-semantics
SGD under the reference's LR schedule.  Run directly, every rank of
``--world_size`` lives in this process on the stacked transport
(``parallel/collectives.py``); on one GPU the default world is 1.
Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment), SLURM or
OpenMPI, or with the reference's flags (``--multihost True
--coordinator_address host:port --num_processes N --process_id i``,
``parallel/discovery.py``) each process
holds one rank on the ``torch.distributed`` transport
(``parallel/multihost.py``): on ``cuda:{LOCAL_RANK % cards}`` over NCCL,
or over gloo where ranks share a card or with ``--device cpu``; rank 0
prints.

Example (CPU, the kernels' plain twins)::

    python -m stochastic_gradient_push_torch.run.gossip_lm --device cpu \\
      --world_size 4 --vocab_size 256 --d_model 64 --n_layers 2 \\
      --n_heads 1 --d_ff 128 --seq_len 64 --batch_size 2 --num_steps 10

On a GPU, ``--world_size 4 --gossip_kernel pallas`` runs the four ranks
stacked on the card with the gossip transport kernels
(``ops/gossip_kernel.py``); ``--overlap True --staleness 2`` makes it
OSGP; ``--gossip_buckets`` sets the transport buckets.  ``pallas`` needs
the card (``KernelBackendError`` on ``--device cpu``); under ``torchrun``
it is the cross-process transport kernel (peer landing blocks mapped by
CUDA IPC, with a flag barrier).  ``--gossip_every k`` fires a round every k-th step;
``--global_avg_every k`` takes an exact global average every k steps
(unset: the topology plan decides).  The planner's flags
(``--topology auto|synth|<name>``, ``--synth_*``, ``--gap_floor``,
``--slice_size``, ``--dcn_cost``, ``--ici_cost``, ``--mixing_alpha``;
``run/gossip_sgd.py``) plan a gossip run at world 2 or more and print
its ``gossip plan:`` line; ``--graph_type 6`` is the hierarchical graph.
``--wire_dtype int8 --error_feedback True`` carries error feedback,
``--inject_faults SPEC`` drills faults into the rounds and
``--health_every k`` (a multiple of ``--print_freq``) prints ``gossip
health:`` lines, with ``--residual_floor`` arming the reactive global
average.  ``--trace_dir DIR`` writes the run's telemetry there
(``telemetry/``, the reference's ``run/gossip_lm.py:373-403,695-750``):
``events.jsonl`` with the plan, a ``run_meta`` (``world``, ``dp``,
``sp``, ``tp``, ``ep``, ``pp`` and the comm model — on the flat dp and
dp x sp meshes only, ``null`` under ep, tp and pp, whose shards the
per-rank payload arithmetic does not cover), health and recovery
events, ``step_stats`` and a ``comm`` snapshot at the print cadence
every ``--metrics_every`` steps and a preemption's exit record; and
``trace.json`` (``metrics_fetch``, ``validate``, ``checkpoint_save``
and ``recovery_global_average`` spans), written in a ``finally``.
Under ``torchrun`` each process writes its own ``_rN`` files.

``--sp k`` cuts each sequence into ``k`` contiguous shards
(``parallel/seq.py``): ``--world_size / --sp`` replicas gossip, and the
graph, the LR scaling, the batches and tokens/s count those replicas.
Run directly, a replica's shards are held stacked beside it; under
``torchrun`` each of the ``P`` processes holds one shard, process ``p``
shard ``p % k`` of replica ``p // k`` (the reference's ``(gossip,
seq)`` device order, ``parallel/mesh.py``): keys and values travel the
ring and the loss and gradients are meaned on the replica's sp group,
the gossip round and the metrics' means run on the shard index's dp
group, and the signal and resume agreement on the world.  Attention
then runs as a ring: ``--attn ring`` (plain PyTorch, the default under
``--sp > 1``) or ``ring_flash`` (the flash kernels as ring ticks);
``--remat True`` recomputes each block in the backward.  On the GPU::

    python -m stochastic_gradient_push_torch.run.gossip_lm --world_size 8 \
      --sp 4 --attn ring_flash --remat True --gossip_kernel pallas \
      --vocab_size 32000 --d_model 768 --n_layers 12 --n_heads 12 \
      --d_ff 3072 --seq_len 4096 --batch_size 2

``--tp k`` splits each projection Megatron-style over ``k`` tensor
shards (``parallel/tp.py``, the reference's ``(gossip, tp)`` and
``(gossip, seq, tp)`` meshes): ``--world_size / (--sp · --tp)`` replicas
gossip; ``d_model``, ``d_ff`` and ``vocab_size`` must divide by ``k``
(each kernel's columns split evenly, as the reference's GSPMD splits
them; ``n_heads`` is free, a head may straddle two shards).
Run directly, a replica's shards are held stacked beside it; under
``torchrun`` process ``p`` holds tp shard ``p % k`` of sequence shard
``(p // k) % sp`` of replica ``p // (sp · k)``: the Megatron sums (after
``o`` and ``down``, the gradients of the column layers' inputs, the
vocabulary-parallel loss, the grad norm) run on the ``(replica, shard)``
tp group, each ``(shard, t)`` index's slices gossip on its dp group, and
checkpoints go through ``--ckpt_backend orbax`` (forced, and logged).
The stacked run's files hold the logical leaves, so they resume at any
``--tp``.  The reference's refusals stand: a world that ``sp·tp`` does
not divide, ``--tp`` with ring attention at ``--sp 1``, ``--health_every``
with ``--tp``; an int8 wire whose blocks a shard would cut, and
cross-world resume, are refused by name.  On the GPU::

    python -m stochastic_gradient_push_torch.run.gossip_lm --world_size 4 \
      --tp 2 --precision bf16 --gossip_kernel pallas --vocab_size 32000 \
      --d_model 768 --n_layers 12 --n_heads 12 --d_ff 3072 --seq_len 1024

``--moe_experts M`` makes every ``--moe_every``-th block (default 2) a
top-1 switch mixture of ``M`` experts (``models/moe.py``, capacity
factor 1.25): the objective adds 0.01 times the blocks' load-balancing
loss, ``ppl`` stays the bare cross-entropy's, and the CSV gains a
``moe_dropped`` column.  At ``--sp`` > 1 each sequence shard routes its
own tokens.  ``--ep k`` splits the experts over ``k`` expert shards
(``parallel/ep.py``, the reference's ``(gossip, ep)`` and ``(gossip, ep,
seq)`` meshes): ``--world_size / (--sp · --tp · --ep)`` replicas gossip,
each ep shard carries its own tokens (the LR and tokens/s count ``dp ·
ep`` batches), and every gradient is the mean over the ep shards.  Run
directly, a replica's ep shards are held stacked beside it (with
``--sp`` > 1 too); under ``torchrun`` process ``p`` holds ep shard ``p %
k`` of replica ``p // k``: the token exchange and the means over ep run
on the replica's ep group, each ep index's slices gossip on its dp group,
and checkpoints go through ``--ckpt_backend orbax`` (forced, and
logged).  With ``--tp`` the experts split their F dim over the tp
shards (the reference's ``(gossip, tp)``, ``(gossip, seq, tp)``,
``(gossip, ep, tp)`` and ``(gossip, ep, seq, tp)`` meshes): under
``torchrun`` process ``p`` holds ``(replica, e, shard, t)`` of
``parallel/mesh.py::DpSpLayout``, its exchange on the ep group of its
``(replica, shard, t)``, its tp sums on the tp group of its ``(replica,
e, shard)``.  The reference's refusals stand (``--ep`` without
``--moe_experts``, experts that ``k`` does not divide, ``--ep`` with ring
attention at ``--sp 1``, ``--health_every`` with ``--ep`` or ``--tp``).
On the GPU::

    python -m stochastic_gradient_push_torch.run.gossip_lm --world_size 8 \
      --moe_experts 8 --ep 2 --tp 2 --precision bf16 --gossip_kernel pallas \
      --vocab_size 32000 --d_model 768 --n_layers 12 --n_heads 12 \
      --d_ff 3072 --seq_len 1024

``--pp k --n_micro m`` runs GPipe (``train/pp.py``, the reference's
``(gossip, pipe)``, ``(gossip, pipe, seq)``, ``(gossip, pipe, ep)`` and
``(gossip, pipe, ep, seq)`` meshes): each replica's layers are cut into
``k`` stages and its batch into ``m`` microbatches, ``--world_size /
(--pp · --ep · --sp)`` replicas gossip, and ``grad_norm`` is the mean
over the stages of each stage's norm (the reference's).  Run directly,
a replica's stages are held stacked beside it; under ``torchrun`` each
process holds one ``(replica, stage, ep shard, sequence shard)``,
process ``p = ((replica·k + s)·ep + e)·sp + shard`` (the reference's
``(gossip, pipe, ep, seq)`` device order; ``(gossip, pipe)`` is stage
``p % k`` of replica ``p // k``) fed its replica's, ep shard's and
sequence shard's tokens: the stage hand-offs and the sum of the
replicated leaves' gradients run on the pipe group of its ``(replica,
e, shard)``, ring shifts and the sequence mean inside each tick on its
stage's sp group, the token exchanges and the ep means on its stage's
ep group, each ``(stage, e, shard)``'s leaves gossip on its dp group,
and checkpoints go through ``--ckpt_backend orbax`` (forced, and
logged; an expert stack as ``[dp, L, E, ...]``, pipe on the layer dim
and ep on the expert dim).  The reference's refusals stand, with its
messages: ``--pp`` with ``--tp``, ``--pp --ep`` without
``--moe_experts``, ``--moe_every`` other than 1, ``--n_micro`` < 1,
layers or a batch that ``--pp`` or ``--n_micro`` do not divide, ring
attention at ``--sp 1``, ``--grad_accum`` and ``--health_every`` with
``--pp``; an int8 wire whose stacked stages would cut the reference's
blocks, and cross-world resume at ``--pp`` > 1, are refused by name.
On the GPU::

    python -m stochastic_gradient_push_torch.run.gossip_lm --world_size 4 \
      --pp 2 --n_micro 4 --precision bf16 --gossip_kernel pallas \
      --vocab_size 32000 --d_model 768 --n_layers 12 --n_heads 12 \
      --d_ff 3072 --seq_len 1024

and ``(gossip, pipe, ep, seq)`` one block a process (8 processes)::

    torchrun --nproc_per_node 8 -m \
      stochastic_gradient_push_torch.run.gossip_lm \
      --pp 2 --ep 2 --sp 2 --n_micro 4 --moe_experts 8 --moe_every 1 \
      --attn ring_flash --precision bf16 --vocab_size 32000 --d_model 768 \
      --n_layers 4 --n_heads 12 --d_ff 3072 --seq_len 1024 --batch_size 8

``--precision bf16`` (the reference's flag) computes the model in
bf16 on fp32 parameters (``models/transformer.py``): bf16 matmuls, the
bf16 forms of the flash kernels, LayerNorm and the loss in fp32; the
optimizer and the gossip round stay fp32.  It combines with every
``--attn``, ``--sp``, ``--remat``, algorithm and ``--gossip_kernel``.

It runs on CUDA unless ``--device cpu``; ``--attn`` defaults to
``flash`` (the hand-written kernels, forward and backward, on CUDA)
without ``--sp``.
Ported flags keep the reference's names and defaults.  ``--fleet True``
(with ``--trace_dir``; ``--host_id`` needs it) marks one host of a
fleet under ``scripts/torch_fleet.py``: ``run_meta`` carries ``fleet``
and ``host_id``, and a resume leaves a cross-world reshard to the pod
coordinator.  The one flag of the reference left, ``--attn_block_k``
(the TPU's attention block rule), parses with its default and is
refused, by name, when given another value: none is silently ignored.

The harness (the reference's, ``run/gossip_lm.py:752-1216`` there):

* ``--corpus_file`` trains on a file (``data/lm.py::load_corpus``:
  ``.npy``/``.npz`` token ids, or raw bytes at ``--vocab_size`` >= 256)
  instead of the synthetic Markov corpus.
* ``--val_frac f`` holds out the corpus tail (at least one validation
  batch; refused past half the corpus) and validates the de-biased
  replicas on ``--val_batches`` batches every ``--val_every`` steps (a
  multiple of ``--print_freq``; 0: at the end only) and at the last
  step; its wall time is left out of ``tokens_per_sec``.
* Into ``--checkpoint_dir`` (default ``./checkpoints``) it writes the
  CSV ``{tag}out_n{world}.csv`` (``{tag}out_p{process}_n{world}.csv``
  per process under ``torchrun``), its rows also printed to stdout, and
  one checkpoint file a gossip replica, ``{tag}checkpoint_r{rank}_
  n{world}.ckpt`` (``utils/checkpoint.py``; ``world`` is the launched
  world, ``dp x sp``), or under ``torchrun`` at ``--sp`` > 1 one a
  process, ``{tag}checkpoint_r{replica}_s{shard}_n{world}.ckpt`` (at
  ``--tp`` > 1 under ``torchrun``: the DCP backend): every
  ``--ckpt_every`` steps and at the end, each save with the overlap FIFO
  drained first, the run going on from the drained state.
* ``--resume True`` restores the files and fast-forwards the data
  stream, so a resumed run equals one that never stopped; under
  ``torchrun`` every process resumes from the least step restored, or
  all start from step 0 when a process lacks its file.  In one process
  at ``--sp 1`` and ``--tp 1``, a set of another world is resharded to
  this one first (the push-sum consensus, ``supervise/reshard.py``), as
  the reference does; under ``--sp`` > 1, ``--tp`` > 1 or ``torchrun``
  it is refused by name.
* ``--ckpt_backend orbax`` saves through ``torch.distributed.checkpoint``
  (``utils/dcp_ckpt.py``) keyed by step: one root
  ``{tag}dcp_r0_n{world}``, each save's host copy made before the run
  goes on and its write in the background, the last 3 steps kept; under
  ``torchrun`` one shared ``{tag}dcp_global_n{world}`` written by every
  process, synchronously, each leaf placed on the ``(dp, pp, ep, sp,
  tp)`` mesh (a replica's copies written once, a split leaf as its
  logical rows).  A preemption exit and the run's end wait for the write
  in flight.
* SIGUSR1/SIGTERM: at the next step boundary (agreed across processes
  under ``torchrun``) the run saves and exits 75, the requeue status.
* ``--heartbeat_timeout`` logs a metrics fetch that stalls (from the
  second print on: the first carries the warm-up); ``--profile_dir``
  writes a ``torch.profiler`` Chrome trace of steps
  ``[--profile_start_step, +--profile_steps)``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

__all__ = ["main", "build_parser", "UNPORTED", "split_corpus"]

# flag -> (reference default, type, what it belongs to): parsed so a
# reference command line is accepted, refused when not at its default
UNPORTED = {
    "--attn_block_k": (0, int, "the TPU attention block rule"),
}
ATTN_CHOICES = (None, "full", "blockwise", "flash", "ring", "ring_flash")
# --precision -> the model's compute dtype (the reference's cfg.dtype,
# run/gossip_lm.py:543 there); parameters, momentum and the gossip round
# stay fp32
PRECISIONS = {"fp32": "float32", "bf16": "bfloat16"}


def _str_bool(v) -> bool:
    return str(v) == "True"


def build_parser() -> argparse.ArgumentParser:
    from ..ops.gossip_kernel import GOSSIP_KERNELS
    from ..parallel.wire import WIRE_DTYPES
    from ..topology import GRAPH_TOPOLOGIES
    from .gossip_sgd import (add_fleet_flags, add_multihost_flags,
                             add_planner_flags, add_profile_flags)

    p = argparse.ArgumentParser(description="Gossip LM on a GPU (PyTorch)")
    p.add_argument("--all_reduce", default="False", type=str)
    p.add_argument("--push_sum", default="True", type=str,
                   help="False: D-PSGD (doubly-stochastic gossip)")
    p.add_argument("--bilat", default="False", type=str,
                   help="AD-PSGD: bilateral perfect-matching averaging "
                        "(synchronous formulation)")
    p.add_argument("--graph_type", default=5, type=int,
                   choices=sorted(GRAPH_TOPOLOGIES))
    add_planner_flags(p)
    p.add_argument("--peers_per_itr", default=1, type=int)
    p.add_argument("--wire_dtype", default=None, choices=WIRE_DTYPES,
                   help="gossip wire codec; the push-sum weight lane "
                        "always ships exact f32")
    p.add_argument("--wire_block", default=64, type=int,
                   help="int8 codec block size")
    p.add_argument("--error_feedback", default="False", type=str,
                   help="carry per-rank error-feedback residuals (needs "
                        "a lossy --wire_dtype)")
    p.add_argument("--gossip_comm_dtype", default=None,
                   choices=[None, "bf16"],
                   help="DEPRECATED alias for --wire_dtype bf16")
    p.add_argument("--inject_faults", default=None, type=str,
                   help="deterministic fault injection at the gossip "
                        "round (resilience/faults.py grammar); "
                        "mass-conserving drops, push-sum only")
    p.add_argument("--health_every", default=0, type=int,
                   help="emit a 'gossip health:' line every k steps (a "
                        "multiple of --print_freq); excursions arm the "
                        "recovery policy; 0 disables")
    p.add_argument("--residual_floor", default=0.01, type=float,
                   help="consensus residual above which recovery fires "
                        "an exact global average (with --health_every)")
    p.add_argument("--overlap", default="False", type=str,
                   help="OSGP: launch each round at the top of the step, "
                        "consume it staleness-1 steps later")
    p.add_argument("--staleness", default=0, type=int,
                   help="overlap in-flight FIFO depth (0 = 1)")
    p.add_argument("--gossip_kernel", default="xla",
                   choices=list(GOSSIP_KERNELS),
                   help="gossip transport lane: 'pallas' runs the payload "
                        "through the CUDA start/wait kernels on the "
                        "stacked lane, 'auto' picks them on a CUDA device, "
                        "'xla' (default) is the plain transport")
    p.add_argument("--gossip_buckets", default=1, type=int,
                   help="kernel-lane transport buckets per round")
    p.add_argument("--gossip_every", default=1, type=int,
                   help="gossip on every k-th step (communication "
                        "thinning)")
    p.add_argument("--global_avg_every", default=None, type=int,
                   help="exact global average every k steps; unset = the "
                        "planner decides, 0 = off, k = every k steps")
    p.add_argument("--lr", default=0.5, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--nesterov", default="False", type=str)
    p.add_argument("--warmup", default="False", type=str)
    p.add_argument("--warmup_steps", default=None, type=int,
                   help="linear warmup horizon (default: num_steps // 10)")
    p.add_argument("--vocab_size", default=256, type=int)
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--n_layers", default=4, type=int)
    p.add_argument("--n_heads", default=8, type=int)
    p.add_argument("--d_ff", default=1024, type=int)
    p.add_argument("--seq_len", default=256, type=int)
    p.add_argument("--attn", default=None, choices=ATTN_CHOICES,
                   help="default: ring when --sp > 1, else flash (the CUDA "
                        "kernels; plain twins on CPU). ring_flash runs the "
                        "flash kernels as ring ticks, ring and blockwise "
                        "are plain PyTorch, full is dense attention")
    p.add_argument("--attn_block", default=0, type=int,
                   help="blockwise only: the key block (0 = min(128, "
                        "seq_len)). flash and ring_flash refuse it: the "
                        "kernels' tiles are their own and ring_flash takes "
                        "any shard length (the reference's min(128, shard) "
                        "rule is its TPU block rule)")
    p.add_argument("--remat", default="False", type=str,
                   help="recompute each block's forward in the backward")
    p.add_argument("--precision", default="fp32", choices=list(PRECISIONS),
                   help="compute dtype of the model (bf16: bf16 matmuls, "
                        "embedding and residual stream, the bf16 flash "
                        "kernels; LayerNorm, softmax and loss in fp32); "
                        "parameters, optimizer state and gossip stay fp32")
    p.add_argument("--sp", default=1, type=int,
                   help="sequence-parallel shards per replica: "
                        "--world_size / --sp replicas gossip; stacked on "
                        "the device, or one a process under torchrun")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel (Megatron) shards per replica: "
                        "--world_size / (--sp * --tp) replicas gossip; "
                        "stacked on the device, or one a process under "
                        "torchrun")
    p.add_argument("--ep", default=1, type=int,
                   help="expert-parallel shards (requires --moe_experts; "
                        "each ep shard also carries its own tokens)")
    p.add_argument("--pp", default=1, type=int,
                   help="pipeline stages per replica (GPipe microbatch "
                        "schedule): --world_size / (--pp * --ep * --sp) "
                        "replicas gossip; stacked on the device, or one "
                        "stage a process under torchrun")
    p.add_argument("--n_micro", default=4, type=int,
                   help="microbatches per step when --pp > 1 (must divide "
                        "batch_size; bubble fraction is "
                        "(pp-1)/(n_micro+pp-1))")
    p.add_argument("--moe_experts", default=0, type=int,
                   help="switch-MoE experts (0: dense FFN blocks)")
    p.add_argument("--moe_every", default=2, type=int,
                   help="every k-th block is a MoE block")
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--world_size", default=None, type=int,
                   help="gossip ranks, all held in this process "
                        "(default 1); under torchrun, the launched "
                        "world")
    p.add_argument("--batch_size", default=8, type=int,
                   help="sequences per rank per step")
    p.add_argument("--num_steps", default=1000, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--seed", default=47, type=int)
    p.add_argument("--corpus_tokens", default=500_000, type=int)
    p.add_argument("--corpus_file", default=None,
                   help="real corpus: .npy/.npz pre-tokenized int array, "
                        "or any file read as raw bytes (byte-level LM, "
                        "vocab_size >= 256); default: synthetic Markov")
    p.add_argument("--checkpoint_dir", default="./checkpoints", type=str,
                   help="the CSV and the checkpoint files go here")
    add_multihost_flags(p)
    p.add_argument("--tag", default="lm_", type=str)
    p.add_argument("--ckpt_every", default=0, type=int,
                   help="checkpoint every N steps (0 = only at the end)")
    p.add_argument("--ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack (the reference's name): one torch.save "
                        "file a replica; orbax: torch.distributed."
                        "checkpoint (utils/dcp_ckpt.py), saves keyed by "
                        "step, asynchronous in one process, the last 3 "
                        "kept, one shared checkpoint under torchrun")
    p.add_argument("--resume", default="False", type=str)
    p.add_argument("--heartbeat_timeout", default=300, type=int,
                   help="log an error if a metrics fetch stalls longer "
                        "than this many seconds (a hung kernel or a "
                        "dead peer process); 0 disables")
    p.add_argument("--val_frac", default=0.0, type=float,
                   help="hold out this fraction of the corpus tail for "
                        "validation (0 = off); val_loss/val_ppl columns "
                        "join the CSV")
    p.add_argument("--val_every", default=0, type=int,
                   help="validate every N steps (0 = only at the end); "
                        "a multiple of --print_freq")
    p.add_argument("--val_batches", default=8, type=int,
                   help="validation batches per evaluation")
    add_profile_flags(p)
    add_fleet_flags(p)
    p.add_argument("--trace_dir", default=None, type=str,
                   help="run telemetry directory (telemetry/): "
                        "trace.json host spans + events.jsonl typed "
                        "plan/health/recovery/comm events.  Unset = "
                        "telemetry off")
    p.add_argument("--metrics_every", default=0, type=int,
                   help="emit a step_stats + comm telemetry event every "
                        "k steps (rides the --print_freq metrics fetch "
                        "cadence; 0 = only the final comm snapshot); "
                        "requires --trace_dir")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain twins)")
    for flag, (default, typ, _) in UNPORTED.items():
        p.add_argument(flag, default=default, type=typ,
                       help=argparse.SUPPRESS)
    return p


def refuse_unported(args) -> None:
    """SystemExit naming the first flag set to a feature not ported."""
    for flag, (default, _, feature) in UNPORTED.items():
        value = getattr(args, flag[2:])
        if default in ("True", "False"):
            changed = _str_bool(value) != _str_bool(default)
        else:
            changed = value != default
        if changed:
            raise SystemExit(
                f"{flag} {value}: {feature} is not ported to "
                f"stochastic_gradient_push_torch yet (a later slice; "
                f"ROADMAP.md Queue 1)")


def resolve_seq_flags(args, world: int) -> tuple[int, str]:
    """``(dp, attn)`` for ``--sp``, ``--tp``, ``--ep`` and ``--pp`` over
    ``world`` ranks (processes under ``torchrun``), with the reference's
    checks (run/gossip_lm.py:269-316, 361-366, 494-533): ``dp = world //
    (sp · tp · ep · pp)`` replicas gossip, each holding ``pp`` stages of
    ``ep`` expert shards of ``sp`` sequence shards of ``tp`` tensor
    shards; an unset ``--attn`` is ``ring`` under sp > 1, else
    ``flash``.  ``d_model``, ``d_ff`` and ``vocab_size`` must divide by
    ``tp``, as the reference's GSPMD refuses a kernel it cannot split
    evenly (by name here); ``n_heads`` is free."""
    from ..parallel.mesh import make_dp_sp_layout
    from ..parallel.tp import check_tp_dims

    sp, tp, ep, pp = args.sp, args.tp, args.ep, args.pp
    if sp < 1:
        raise SystemExit("--sp must be >= 1")
    if tp < 1 or ep < 1 or pp < 1:
        raise SystemExit("--sp, --tp, --ep and --pp must be >= 1")
    if pp > 1:
        # the reference's pipeline fences (run/gossip_lm.py:272-295 there)
        if tp > 1:
            raise SystemExit("--pp composes with gossip DP, --sp, "
                             "--moe_experts and --ep only (not --tp)")
        if ep > 1 and not args.moe_experts:
            raise SystemExit("--pp with --ep requires --moe_experts > 0")
        if args.moe_experts and args.moe_every != 1:
            raise SystemExit("--pp with --moe_experts requires "
                             "--moe_every 1 (the stage stack is one "
                             "uniform scan)")
        if args.n_micro < 1:
            raise SystemExit(f"--n_micro must be >= 1 (got {args.n_micro})")
        if args.n_layers % pp:
            raise SystemExit(f"n_layers {args.n_layers} not divisible "
                             f"by pp {pp}")
        if args.batch_size % args.n_micro:
            raise SystemExit(f"batch_size {args.batch_size} not divisible "
                             f"by n_micro {args.n_micro}")
    if ep > 1 and not args.moe_experts:
        raise SystemExit("--ep requires --moe_experts > 0")
    if args.moe_experts and args.moe_experts % ep:
        raise SystemExit(
            f"moe_experts {args.moe_experts} not divisible by ep {ep}")
    try:
        make_dp_sp_layout(world, sp, tp, ep, pp)
        check_tp_dims(args.d_model, args.d_ff, args.vocab_size, tp)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.seq_len % sp:
        raise SystemExit(f"seq_len {args.seq_len} not divisible by sp {sp}")
    if args.moe_experts < 0:
        raise SystemExit("--moe_experts must be >= 0")
    if args.moe_experts and args.moe_every < 1:
        raise SystemExit("moe_every must be >= 1 when moe_experts > 0")
    if args.health_every and (tp > 1 or ep > 1 or pp > 1):
        raise SystemExit("--health_every composes with the flat dp "
                         "and dp×sp meshes only (not ep/tp/pp)")
    attn = args.attn or ("ring" if sp > 1 else "flash")
    if sp > 1 and attn not in ("ring", "ring_flash"):
        raise SystemExit("--sp > 1 requires ring attention")
    if tp > 1 and sp == 1 and attn in ("ring", "ring_flash"):
        raise SystemExit(
            "--tp with ring attention requires --sp > 1 (3-D mesh)")
    if ep > 1 and sp == 1 and attn in ("ring", "ring_flash"):
        raise SystemExit(
            "--ep with ring attention needs --sp > 1 (the 3-D "
            "gossip × ep × seq mesh)")
    if pp > 1 and sp == 1 and attn in ("ring", "ring_flash"):
        raise SystemExit("--pp with ring attention needs --sp > 1 "
                         "(the 3-D gossip × pipe × seq mesh)")
    if args.grad_accum > 1 and pp > 1:
        raise SystemExit("--grad_accum composes with the flat meshes; "
                         "pipeline runs control microbatching with "
                         "--n_micro")
    if args.attn_block and attn != "blockwise":
        raise SystemExit(
            f"--attn_block {args.attn_block} with --attn {attn}: the block "
            f"is the blockwise attention's; the flash kernels' tiles are "
            f"their own")
    return world // (sp * tp * ep * pp), attn


def resolve_staleness_flag(args, overlap: bool) -> None:
    """Validate ``--staleness`` in place (the reference's rule, run/
    gossip_sgd.py:269-283, without its ``--synch_freq`` alias):
    non-negative and overlap-only."""
    if args.staleness < 0:
        raise SystemExit("--staleness must be >= 0 (0 = derive from "
                         "--synch_freq)")
    if args.staleness > 1 and not overlap:
        raise SystemExit("--staleness is an overlap-mode knob")


def resolve_kernel_flag(args, device, launched: int):
    """The ``--gossip_kernel`` lane for this run: ``pallas`` needs a CUDA
    device (``KernelBackendError`` otherwise; under ``torchrun`` it is
    the cross-process transport kernel)."""
    from ..ops.gossip_kernel import KernelBackendError, resolve_gossip_kernel

    if args.gossip_buckets < 1:
        raise SystemExit("--gossip_buckets must be >= 1, got "
                         f"{args.gossip_buckets}")
    if args.gossip_every < 1:
        raise SystemExit("--gossip_every must be >= 1, got "
                         f"{args.gossip_every}")
    if (args.global_avg_every or 0) < 0:
        raise SystemExit("--global_avg_every must be >= 0, got "
                         f"{args.global_avg_every}")
    try:
        return resolve_gossip_kernel(args.gossip_kernel, device=device)
    except KernelBackendError as e:
        where = (" under torchrun (the cross-process transport kernel)"
                 if launched > 1 else "")
        raise KernelBackendError(f"--gossip_kernel {args.gossip_kernel}"
                                 f"{where}: {e}") from None


def resolve_harness_flags(args) -> None:
    """Validate the harness's flags in place (the reference's rules):
    the profile window's, the watchdog's and the validation cadence."""
    from .gossip_sgd import resolve_profile_flags

    resolve_profile_flags(args)
    if args.heartbeat_timeout < 0:
        raise SystemExit("--heartbeat_timeout must be >= 0 (0 disables)")
    if args.val_frac > 0 and args.val_every \
            and args.val_every % args.print_freq:
        raise SystemExit(
            f"--val_every {args.val_every} must be a multiple of "
            f"--print_freq {args.print_freq} (validation rows ride the "
            "CSV print cadence)")


def split_corpus(corpus, val_frac: float, min_val: int):
    """``(train, val)``: the corpus tail held out, ``val_frac`` of it and
    at least ``min_val`` tokens (one validation batch); ``val`` is None
    at ``val_frac`` 0."""
    if val_frac <= 0:
        return corpus, None
    n_val = max(int(len(corpus) * val_frac), min_val)
    if n_val >= len(corpus) // 2:
        raise SystemExit("--val_frac leaves too little training data")
    return corpus[:-n_val], corpus[-n_val:]


def open_csv(path: str, header: str, resumed: bool, warn) -> None:
    """Start the run's CSV, or on a resume append to the one there: an
    older header is rewritten first, each old value under its column's
    name (missing columns left empty), through a temporary file and a
    rename, so a crash mid-rewrite keeps the history."""
    if not (resumed and os.path.isfile(path)):
        with open(path, "w") as f:
            print(header, file=f)
        return
    with open(path) as f:
        old_lines = f.read().splitlines()
    if not old_lines or old_lines[0] == header:
        return
    warn(f"existing CSV header {old_lines[0]!r} != current schema "
         f"{header!r}; remapping old rows to the new schema (missing "
         "columns left empty)")
    old_cols, new_cols = old_lines[0].split(","), header.split(",")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        print(header, file=f)
        for row in old_lines[1:]:
            vals = dict(zip(old_cols, row.split(",")))
            print(",".join(vals.get(c, "") for c in new_cols), file=f)
    os.replace(tmp, path)


def main(argv=None) -> dict:
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGUSR1, signal.SIGTERM)}
    try:
        return _main(argv)
    finally:
        # a library caller gets its own handlers back
        for s, h in handlers.items():
            signal.signal(s, h)


def _main(argv) -> dict:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    from .gossip_sgd import (discover_launch, resolve_fleet_flags,
                             resolve_wire_alias)

    resolve_wire_alias(args)
    resolve_fleet_flags(args)

    import contextlib

    import numpy as np
    import torch

    from ..algorithms import adpsgd, all_reduce, dpsgd, drain_state, sgp
    from ..data.lm import lm_batches, load_corpus, synthetic_lm_corpus
    from ..device import resolve_device
    from ..models.transformer import TransformerConfig
    from ..parallel.multihost import (consensus_resume_point,
                                      host_local_slice, initialize_multihost,
                                      leave, process_device)
    from ..parallel.collectives import DistTransport, StackedTransport
    from ..parallel.ep import DistEp, StackedEp
    from ..parallel.mesh import join_groups, make_dp_sp_layout
    from ..parallel.pipeline import DistPipe, StackedPipe
    from ..parallel.seq import DistSeq, StackedSeq
    from ..parallel.tp import DistTp, StackedTp, gather_state, shard_state
    from ..parallel.wire import get_codec
    from ..planner import make_interconnect
    from ..telemetry import make_run_telemetry
    from ..topology import (GRAPH_TOPOLOGIES, TOPOLOGY_NAMES,
                            build_pairing_schedule, build_schedule)
    from .gossip_sgd import parse_mixing_alpha, plan_topology, \
        synth_plan_config
    from ..train.lm import (build_lm_eval_step, build_lm_train_step,
                            init_lm_state, make_model)
    from ..train.pp import (build_pp_eval_step, build_pp_train_step,
                            init_pp_state, is_stage, make_pp_model)
    from ..train.lr import WARMUP_EPOCHS, LRSchedule
    from ..train.state import sgd
    from ..utils.checkpoint import (REQUEUE_EXIT_CODE, CheckpointManager,
                                    ClusterManager)
    from ..utils.logging import make_logger
    from ..utils.profiling import ProfileWindow, StepWatchdog

    sb = _str_bool
    resolve_staleness_flag(args, sb(args.overlap))
    resolve_harness_flags(args)
    ef = sb(args.error_feedback)
    if ef and args.wire_dtype not in ("bf16", "int8"):
        raise SystemExit(
            "--error_feedback needs a lossy --wire_dtype (bf16/int8): "
            "an exact wire has no quantization error to feed back")
    fault_plan = None
    if args.inject_faults:
        if sb(args.all_reduce) or sb(args.bilat) or not sb(args.push_sum):
            raise SystemExit("--inject_faults needs push-sum gossip: only "
                             "push-sum's mass accounting keeps the mean "
                             "exact under dropped edges")
        from ..resilience import parse_fault_spec

        fault_plan = parse_fault_spec(args.inject_faults)
    if args.metrics_every < 0:
        raise SystemExit("--metrics_every must be >= 0")
    if args.metrics_every and not args.trace_dir:
        raise SystemExit("--metrics_every needs --trace_dir (telemetry "
                         "events have nowhere to go without it)")
    if args.health_every < 0:
        raise SystemExit("--health_every must be >= 0")
    if args.health_every and args.health_every % args.print_freq:
        raise SystemExit(
            f"--health_every {args.health_every} must be a multiple of "
            f"--print_freq {args.print_freq} (health signals ride the "
            "metrics fetch cadence)")
    info = discover_launch(args)
    launched = info.world_size
    device = (process_device(args.device, info) if launched > 1
              else resolve_device(args.device))
    world = args.world_size or 1
    dp, attn = resolve_seq_flags(args, launched if launched > 1 else world)
    lane = resolve_kernel_flag(args, device, launched)
    tp_n, ep_n, pp_n = args.tp, args.ep, args.pp
    owns_group = False
    forced = None
    # the sequence, tensor, expert and pipeline axes across processes:
    # this process's shards, its replica's sp, tp, ep and pipe groups,
    # and the world for agreement (signals, resume)
    dist_seq = dist_tp = dist_ep = dist_pipe = agree = layout = None
    if launched > 1:
        if args.world_size not in (None, launched):
            raise SystemExit(f"--world_size {args.world_size} but the "
                             f"launcher started {launched} processes")
        if (tp_n > 1 or ep_n > 1 or pp_n > 1) and \
                args.ckpt_backend != "orbax":
            # the reference forces its global backend for a tp-, ep- or
            # pp-sharded state across processes (run/gossip_lm.py:763-776
            # there)
            axis, n = next((a, k) for a, k in (
                ("--tp", tp_n), ("--ep", ep_n), ("--pp", pp_n)) if k > 1)
            forced = (f"{axis} {n} under torchrun: "
                      f"checkpoints through --ckpt_backend orbax "
                      f"(torch.distributed.checkpoint, one global "
                      f"checkpoint), not {args.ckpt_backend}")
            args.ckpt_backend = "orbax"
        owns_group = not torch.distributed.is_initialized()
        initialize_multihost("xla", device, info)
        world = launched
        if args.sp > 1 or tp_n > 1 or ep_n > 1 or pp_n > 1:
            layout = make_dp_sp_layout(launched, args.sp, tp_n, ep_n, pp_n)
            groups = join_groups(layout, info.rank)
            transport = DistTransport(group=groups.dp,
                                      siblings=layout.all_dp_members())
            if args.sp > 1:
                dist_seq = DistSeq(DistTransport(group=groups.sp))
            if tp_n > 1:
                dist_tp = DistTp(DistTransport(group=groups.tp))
            if ep_n > 1:
                dist_ep = DistEp(DistTransport(group=groups.ep))
            if pp_n > 1:
                dist_pipe = DistPipe(DistTransport(group=groups.pp))
            agree = DistTransport()
        else:
            transport = agree = DistTransport()
    else:
        transport = StackedTransport(dp)
    rank0 = info.rank == 0
    log0 = print if rank0 else (lambda *a, **k: None)
    import types

    # the plan, health and recovery lines: printed by process 0
    lines = types.SimpleNamespace(
        info=lambda m, *a: log0(m % a if a else m, flush=True),
        warning=lambda m, *a: log0(m % a if a else m, flush=True))
    # telemetry before planning, so the plan's event and the loop's share
    # one events.jsonl (the no-op bundle without --trace_dir)
    rt = make_run_telemetry(args.trace_dir, rank=info.rank, log=lines,
                            metrics_every=args.metrics_every)
    if forced:
        log0(forced, flush=True)
    if args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible "
                         f"by --grad_accum {args.grad_accum}")
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        attn_impl=attn, attn_block_size=args.attn_block or None,
        remat=sb(args.remat),
        dtype=getattr(torch, PRECISIONS[args.precision]), tp=tp_n,
        moe_experts=args.moe_experts, moe_every=args.moe_every, ep=ep_n)
    args.mixing_alpha = parse_mixing_alpha(args.mixing_alpha)
    if args.mixing_alpha is not None and (
            sb(args.all_reduce) or not sb(args.push_sum)):
        raise SystemExit("--mixing_alpha needs push-sum gossip: AllReduce "
                         "doesn't mix, and D-PSGD requires a regular "
                         "(doubly-stochastic) schedule")
    fabric_flags = (args.slice_size is not None
                    or args.dcn_cost is not None
                    or args.ici_cost is not None)
    if (args.mixing_alpha is not None or fabric_flags) \
            and (sb(args.bilat) or sb(args.all_reduce) or dp < 2):
        raise SystemExit("--topology auto / --mixing_alpha / fabric "
                         "flags (--slice_size/--dcn_cost/--ici_cost) "
                         "plan gossip schedules; they do not apply to "
                         "all_reduce/bilateral modes or a "
                         "single-rank world")
    # the launch-time plan, before any model work, as in the reference
    plan = None
    synth_plan_config(args)   # refuses stray --synth_* knobs
    if not sb(args.all_reduce) and not sb(args.bilat) and dp > 1:
        plan = plan_topology(
            args, dp, args.peers_per_itr,
            GRAPH_TOPOLOGIES[args.graph_type], sb(args.push_sum),
            sb(args.overlap), lines, rt.registry)
    elif args.topology is not None and (sb(args.all_reduce)
                                        or sb(args.bilat)):
        raise SystemExit("--topology selects a push-sum/D-PSGD gossip "
                         "graph; it does not apply to all_reduce/bilat "
                         "modes")
    elif args.topology in ("auto", "synth"):
        raise SystemExit(f"--topology {args.topology} plans gossip "
                         "schedules; it does not apply to a "
                         "single-replica mesh")
    # the fabric the plan priced: the recovery re-plans and the comm
    # model's link lanes follow it
    interconnect = make_interconnect(args.slice_size, args.dcn_cost,
                                     args.ici_cost)
    # the plan's graph (a hierarchical plan binds its slice
    # decomposition, a synthesized one its spec), mixing and period
    if plan is not None:
        graph_of, mixing = plan.graph_class, plan.mixing_strategy()
        gae = plan.global_avg_every
    else:
        graph_of = (TOPOLOGY_NAMES[args.topology] if args.topology
                    else GRAPH_TOPOLOGIES[args.graph_type])
        mixing, gae = None, args.global_avg_every or 0
    if sb(args.all_reduce):
        if (args.wire_dtype is not None or sb(args.overlap)
                or args.gossip_kernel != "xla" or args.gossip_buckets != 1
                or args.gossip_every != 1 or args.global_avg_every):
            raise SystemExit("--wire_dtype/--overlap/--gossip_kernel/"
                             "--gossip_buckets/--gossip_every/"
                             "--global_avg_every tune the push-sum gossip; "
                             "they do not apply to --all_reduce True")
        alg = all_reduce(transport)
    elif sb(args.bilat) or not sb(args.push_sum):
        if args.wire_dtype not in (None, "f32") or args.gossip_every != 1 \
                or ef:
            raise SystemExit("gossip_every/wire_dtype/error_feedback are "
                             "push-sum knobs")
        if sb(args.bilat):
            graph = GRAPH_TOPOLOGIES[args.graph_type](
                dp, peers_per_itr=args.peers_per_itr)
            alg = adpsgd(build_pairing_schedule(graph), transport)
        else:
            alg = dpsgd(build_schedule(
                            graph_of(dp, peers_per_itr=args.peers_per_itr),
                            mixing),
                        transport, overlap=sb(args.overlap),
                        staleness=max(1, args.staleness), gossip_kernel=lane,
                        gossip_buckets=args.gossip_buckets,
                        global_avg_every=gae)
    else:
        schedule = build_schedule(
            graph_of(dp, peers_per_itr=args.peers_per_itr), mixing)
        faults = None
        if fault_plan is not None:
            faults = fault_plan.build_masks(schedule,
                                            gossip_every=args.gossip_every)
            log0(f"gossip faults: {fault_plan.summary()}", flush=True)
        alg = sgp(schedule, transport,
                  wire=get_codec(args.wire_dtype, args.wire_block),
                  error_feedback=ef, faults=faults,
                  overlap=sb(args.overlap),
                  staleness=max(1, args.staleness), gossip_kernel=lane,
                  gossip_buckets=args.gossip_buckets,
                  gossip_every=args.gossip_every,
                  global_avg_every=gae)
    tx = sgd(momentum=args.momentum, weight_decay=args.weight_decay,
             nesterov=sb(args.nesterov))
    # the reference's step-based warmup horizon and LR scaling over the
    # data-parallel replicas and ep shards (each carries its own batch;
    # sequence, tensor and pipeline shards do not enlarge it)
    warmup_steps = args.warmup_steps or max(args.num_steps // 10, 1)
    itr_per_epoch = max(warmup_steps // WARMUP_EPOCHS, 1)
    lrs = LRSchedule(ref_lr=args.lr, batch_size=args.batch_size,
                     world_size=dp * ep_n, decay_schedule={},
                     warmup=sb(args.warmup))
    seq = (dist_seq or StackedSeq(args.sp)) if cfg.ring else None
    tp = (dist_tp or StackedTp(tp_n)) if tp_n > 1 else None
    ep = (dist_ep or StackedEp(ep_n)) if ep_n > 1 else None
    pipe = (dist_pipe or StackedPipe(pp_n)) if pp_n > 1 else None
    held = len(transport.ranks)
    try:
        if pipe is not None:
            # GPipe stages (train/pp.py; the reference's build_pp_train_step)
            model = make_pp_model(cfg, pp_n)
            step = build_pp_train_step(
                model, alg, tx, lrs, itr_per_epoch=itr_per_epoch,
                pipe=pipe, n_micro=args.n_micro, seq=seq, ep=ep)
            state = init_pp_state(cfg, alg, tx, held, pp_n,
                                  stages=pipe.stages, seed=args.seed,
                                  device=device, ep=ep)
        else:
            model = make_model(cfg)
            step = build_lm_train_step(
                model, alg, tx, lrs, itr_per_epoch=itr_per_epoch,
                grad_accum=args.grad_accum,
                health_axis=transport if args.health_every > 0 else None,
                seq=seq, tp=tp, ep=ep)
            state = init_lm_state(cfg, alg, tx, held, seed=args.seed,
                                  device=device, tp=tp, ep=ep)
    except ValueError as e:
        # an int8 wire whose blocks a tp, ep or pp shard would cut
        raise SystemExit(str(e)) from None
    log = log0
    monitor = policy = recovery = None
    window = None   # (host clock, steps_done, val_time) at the last read
    if args.health_every > 0:
        # signals ride every step's metrics and are read at the print
        # cadence (the only points the loop reads metrics)
        from ..resilience import (HealthMonitor, RecoveryPolicy,
                                  make_recovery_fn)

        monitor = HealthMonitor(health_every=args.health_every,
                                residual_floor=args.residual_floor,
                                log=lines, registry=rt.registry)
        if dp > 1 and hasattr(alg, "global_average"):
            from ..parallel.wire import wire_stamp

            policy = RecoveryPolicy(
                world=dp, ppi=args.peers_per_itr,
                algorithm="sgp" if sb(args.push_sum) else "dpsgd",
                topology=plan.topology if plan is not None else None,
                residual_floor=args.residual_floor,
                cooldown_steps=args.health_every, log=lines,
                registry=rt.registry, interconnect=interconnect,
                faults=bool(args.inject_faults),
                wire=wire_stamp(args.wire_dtype, args.wire_block, ef),
                synth=plan.synth if plan is not None else None)
            recovery = make_recovery_fn(alg)
    # the logical parameters of a replica (all its tp shards, all its
    # stages)
    n_params = sum(p.numel() * (pp_n if is_stage(n) and pipe else 1)
                   for n, p in model.named_parameters())
    gossip = ""
    if alg.name in ("sgp", "dpsgd"):
        gossip = (f"; gossip lane {alg.transport_kernel_name}, buckets "
                  f"{alg.gossip_buckets}"
                  + (f", overlap staleness {alg.staleness}" if alg.overlap
                     else ""))
    shards = "".join(f" x {a} {n}" for a, n in (
        ("pp", pp_n), ("ep", ep_n), ("sp", args.sp), ("tp", tp_n)) if n > 1)
    shards = f" = dp {dp}{shards}" if shards else ""
    if layout is None:
        here = f"{held} in this process"
    else:
        replica, e, shard, t = layout.grid(info.rank)
        here = (f"process {info.rank}: replica {replica}"
                + (f", stage {layout.stage(info.rank)}" if pp_n > 1 else "")
                + (f", ep shard {e}" if ep_n > 1 else "")
                + (f", shard {shard}" if args.sp > 1 else "")
                + (f", tp shard {t}" if tp_n > 1 else ""))
    moe = (f"; moe {args.moe_experts} experts every {args.moe_every} "
           f"blocks" if args.moe_experts else "")
    if pipe is not None:
        moe += (f"; pipeline {pp_n} stages x {args.n_micro} microbatches "
                f"(bubble {(pp_n - 1) / (args.n_micro + pp_n - 1):.3f})")
    log(f"lm: world {world}{shards} ({here}) on {device}; "
        f"{n_params / 1e6:.2f}M params{moe}; attn={attn}"
        f"{' remat' if cfg.remat else ''}; precision {args.precision}; "
        f"algorithm={alg.name}{gossip}", flush=True)
    if rt.enabled:
        _run_meta(rt, args, state, alg, held, interconnect, world, dp)

    def mean(x) -> float:
        """Mean over all replicas of a per-held-replica metric (a
        collective under torchrun: every process calls it)."""
        return float(transport.allreduce_sum(x.reshape(-1).float())[0]
                     / dp)

    def any_process(flag: bool) -> bool:
        """Whether ``flag`` holds in any process of the world (a
        collective)."""
        x = torch.tensor([float(flag)], device=device)
        return bool(agree.allreduce_max(x)[0])

    # checkpoints: one file a gossip replica (a process under torchrun
    # at --sp > 1), named by the launched world, holding the logical
    # leaves at --tp > 1 and every stage's [pp, L/pp, ...] leaves at --pp
    # > 1, or (--ckpt_backend orbax) one DCP checkpoint keyed by step, on
    # the (dp, pp, ep, sp, tp) mesh under torchrun
    me = info.rank
    logger = make_logger(me)
    warn = logger.warning
    use_dcp = args.ckpt_backend == "orbax"
    if use_dcp:
        from ..utils.dcp_ckpt import DcpCheckpointManager

        ckpt = DcpCheckpointManager(
            args.checkpoint_dir, tag=args.tag,
            rank=transport.rank if launched > 1 else 0, world_size=world,
            layout=layout)
    else:
        ckpt = CheckpointManager(
            args.checkpoint_dir, tag=args.tag, world_size=world,
            ranks=transport.ranks,
            shard=None if dist_seq is None else dist_seq.shards[0])
    # SIGUSR1/SIGTERM raise a flag checked at each step boundary; no
    # requeue command: relaunching is the launcher's
    cluster = ClusterManager(ckpt, rank=me, requeue_command=None)
    if launched > 1:
        cluster.agree = any_process
    start_step = 0
    if sb(args.resume):
        have = ckpt.exists()
        if launched > 1:
            # decided collectively: resume only if every process holds
            # its file, else every process starts from step 0
            every = not any_process(not have)
            if not every:
                warn("checkpoint present here but missing on a peer; "
                     "starting from step 0" if have else
                     f"no checkpoint for rank {me} in "
                     f"{args.checkpoint_dir}; every process starts from "
                     "step 0")
            have = every
        if not have and not args.fleet:
            # a fleet host skips this: the pod coordinator resharded
            # and assigned each host its shard before the relaunch
            have = _reshard_other_world(ckpt, args, world, launched, logger)
        if have:
            if tp is not None and launched == 1:
                # the files hold the logical leaves
                state, meta = ckpt.restore(gather_state(state, tp_n))
                state = shard_state(state, tp_n)
            else:
                state, meta = ckpt.restore(state)
            start_step = int(meta.get("step", 0))
            if launched > 1:
                _, start_step = consensus_resume_point(0, start_step,
                                                       agree, log=warn)
            log(f"resumed from step {start_step}", flush=True)
    if start_step >= args.num_steps:
        log(f"nothing to do: resumed at step {start_step} >= num_steps "
            f"{args.num_steps}", flush=True)
        rt.finish(step=start_step)
        leave(transport, owns_group)
        return {"final_loss": None, "avg_loss": None,
                "tokens_per_sec": 0.0, "already_complete": True}

    def save(st, at: int):
        """Checkpoint ``st`` at step ``at`` with its overlap FIFO drained
        into the params (``drain_state``); returns the drained state, the
        one the run goes on from."""
        st = drain_state(st)
        meta = {"step": at}
        if plan is not None:
            # the launch-time plan rides with the state it shaped
            meta["plan"] = plan.to_dict()
        if monitor is not None and monitor.last_payload:
            meta["health"] = monitor.last_payload
        out = (gather_state(st, tp_n) if tp is not None and launched == 1
               else st)
        with rt.span("checkpoint_save", "checkpoint"):
            if use_dcp:
                ckpt.save(out, meta, epoch_id=at)
            else:
                ckpt.save(out, meta)
        return st

    if args.corpus_file:
        corpus = load_corpus(args.corpus_file, args.vocab_size)
        log(f"corpus: {args.corpus_file} ({len(corpus):,} tokens)",
            flush=True)
    else:
        corpus = synthetic_lm_corpus(args.corpus_tokens,
                                     vocab_size=args.vocab_size,
                                     seed=args.seed)
    # a step's batch: dp replicas' of ep shards' sequences
    rows = dp * ep_n
    corpus, val_corpus = split_corpus(
        corpus, args.val_frac, (args.seq_len + 1) * rows * args.batch_size)
    val_on = val_corpus is not None
    eval_step = None
    if val_on and pipe is not None:
        eval_step = build_pp_eval_step(model, alg, pipe, args.n_micro, seq,
                                       ep)
    elif val_on:
        eval_step = build_lm_eval_step(model, alg, seq, tp, ep)
    out_fname = os.path.join(
        args.checkpoint_dir,
        f"{args.tag}out_n{world}.csv" if launched == 1
        else f"{args.tag}out_p{info.rank}_n{world}.csv")
    moe_on = args.moe_experts > 0
    header = ("step,loss,ppl,lr,tokens_per_sec,grad_norm"
              + (",moe_dropped" if moe_on else "")
              + (",val_loss,val_ppl" if val_on else ""))
    open_csv(out_fname, header, start_step > 0, warn)
    log(header, flush=True)

    # a heartbeat around the blocking metrics fetch, from the second
    # print on: the first carries the warm-up (builds, autotuning)
    watchdog = (StepWatchdog(timeout=args.heartbeat_timeout, rank=me,
                             registry=rt.registry)
                if args.heartbeat_timeout > 0 else None)
    pw = ProfileWindow(args.profile_dir, start_step=args.profile_start_step,
                       num_steps=args.profile_steps, device=device, rank=me)

    def on_device(tokens, targets):
        # [dp·ep, sp, batch, seq_len / sp], row replica·ep + e; flat
        # models take [dp, batch, seq_len]; this process's rows (and
        # shard); with ep [dp, held_ep, (held_sp,) ...], the ep (and
        # sequence) shards held here
        if ep is not None:
            held_ep = np.asarray(ep.shards)
            held_sp = np.asarray(seq.shards) if cfg.ring else 0
            return tuple(torch.from_numpy(np.ascontiguousarray(
                a.reshape(dp, ep_n, *a.shape[1:])[transport.ranks][
                    :, held_ep][:, :, held_sp])
            ).to(device) for a in (tokens, targets))
        mine = host_local_slice({"x": tokens, "y": targets}, transport,
                                None if seq is None else seq.shards)
        return tuple(torch.from_numpy(a if cfg.ring else a[:, 0]).to(device)
                     for a in (mine["x"], mine["y"]))

    val_time = 0.0   # left out of tokens_per_sec

    def validate(st) -> tuple[float, float]:
        """Mean held-out loss of the de-biased replicas over
        ``--val_batches`` batches, and its perplexity."""
        nonlocal val_time
        t_val = time.perf_counter()
        vals = []
        with rt.span("validate", "eval"):
            for vt, vy in lm_batches(val_corpus, rows, args.sp,
                                     args.batch_size, args.seq_len, seed=1):
                vals.append(mean(eval_step(st, *on_device(vt, vy))["loss"]))
                if len(vals) >= args.val_batches:
                    break
        vl = float(np.mean(vals))
        val_time += time.perf_counter() - t_val
        return vl, float(np.exp(vl))

    # resume fast-forward: the data stream restarts where the saved run
    # left off instead of replaying consumed batches
    n_seqs = (len(corpus) - 1) // args.seq_len
    batches_per_epoch = max(1, n_seqs // (rows * args.batch_size))
    epoch, skip = divmod(start_step, batches_per_epoch)
    tokens_per_step = rows * args.batch_size * args.seq_len
    steps_done, last_saved, prints = start_step, start_step - 1, 0
    losses, last_val = [], None
    last_stats = start_step
    t0 = time.perf_counter()
    try:
        while steps_done < args.num_steps:
            for tokens, targets in lm_batches(corpus, rows, args.sp,
                                              args.batch_size, args.seq_len,
                                              seed=args.seed + epoch):
                if skip:
                    skip -= 1
                    continue
                toks, tgts = on_device(tokens, targets)
                pw.maybe_start(steps_done + 1)
                with (torch.profiler.record_function(
                        f"lm_step_{steps_done + 1}") if pw.active
                        else contextlib.nullcontext()):
                    state, metrics = step(state, toks, tgts)
                steps_done += 1
                if rt.comm is not None:
                    # the algorithm's 0-based tick; host integer math
                    rt.comm.on_step(steps_done - 1)
                pw.maybe_stop(steps_done)
                if (steps_done % args.print_freq == 0
                        or steps_done >= args.num_steps):
                    with (watchdog.step() if watchdog is not None
                          and prints else contextlib.nullcontext()), \
                            rt.span("metrics_fetch", "step",
                                    {"step": steps_done} if rt.enabled
                                    else None):
                        # waits for the step
                        got = {k: mean(metrics[k])
                               for k in ("loss", "ppl", "grad_norm")
                               + (("moe_dropped",) if moe_on else ())}
                    prints += 1
                    losses.append(got["loss"])
                    if monitor is not None:
                        state, window = _observe_health(
                            monitor, policy, recovery, alg, state, metrics,
                            steps_done, window, val_time, rt)
                    tps = (tokens_per_step * (steps_done - start_step)
                           / (time.perf_counter() - t0 - val_time))
                    if rt.metrics_every and \
                            steps_done - last_stats >= rt.metrics_every:
                        # step_stats ride the print cadence's metrics
                        # read, the loop's only host sync
                        rt.registry.emit("step_stats", {
                            "loss": round(got["loss"], 6),
                            "tokens_per_sec": round(tps, 1),
                            "grad_norm": round(got["grad_norm"], 6)},
                            step=steps_done)
                        rt.emit_comm(step=steps_done)
                        last_stats = steps_done
                    row = (f"{steps_done},{got['loss']:.4f},"
                           f"{got['ppl']:.2f},{float(metrics['lr']):.5f},"
                           f"{tps:.0f},{got['grad_norm']:.4f}")
                    if moe_on:
                        row += f",{got['moe_dropped']:.4f}"
                    if val_on:
                        if ((args.val_every
                             and steps_done % args.val_every == 0)
                                or steps_done >= args.num_steps):
                            last_val, val_ppl = validate(state)
                            row += f",{last_val:.4f},{val_ppl:.2f}"
                        else:
                            row += ",,"
                    log(row, flush=True)
                    with open(out_fname, "a") as f:
                        print(row, file=f)
                if args.ckpt_every and steps_done % args.ckpt_every == 0:
                    state = save(state, steps_done)
                    last_saved = steps_done
                if cluster.any_rank_signalled():
                    # the step is done: save, free the transport, exit
                    # with the requeue status
                    sig = cluster.last_signal or "peer flag"
                    warn(f"preemption signal ({sig}): checkpointing at "
                         f"step {steps_done} and exiting "
                         f"{REQUEUE_EXIT_CODE} (requeue me)")
                    state = save(state, steps_done)
                    # an asynchronous save lands before the exit
                    ckpt.close()
                    if rt.enabled:
                        rt.registry.emit("run_meta", {
                            "exit_reason": "preempt-requeue",
                            "signal": cluster.last_signal,
                            "exit_code": REQUEUE_EXIT_CODE},
                            step=steps_done, severity="warning")
                    leave(transport, owns_group)
                    raise SystemExit(REQUEUE_EXIT_CODE)
                if steps_done >= args.num_steps:
                    break
            epoch += 1
        if last_saved != steps_done:
            state = save(state, steps_done)
        ckpt.close()
    finally:
        # a run that ended inside the window still writes its trace
        pw.close()
        # trace.json and the last comm snapshot, whatever path leaves
        # the loop (a crash, an exit 75)
        rt.finish(step=steps_done)
    result = {"final_loss": losses[-1], "avg_loss": float(np.mean(losses)),
              "tokens_per_sec": tokens_per_step * (steps_done - start_step)
              / (time.perf_counter() - t0 - val_time)}
    if last_val is not None:
        result["val_loss"] = last_val
    if pw.trace_path is not None:
        result["profile_trace"] = pw.trace_path
    log(json.dumps(result), flush=True)
    leave(transport, owns_group)
    return result


def _reshard_other_world(ckpt, args, world: int, launched: int,
                         log) -> bool:
    """No checkpoint of this world on a resume: reshard another world's
    set into place (``supervise/reshard.py``, the reference's rule: one
    process, ``--sp 1``) and say whether the files are now there; refuse
    by name where the reference does not reshard."""
    from ..supervise.reshard import maybe_cross_world_reshard
    from ..utils.checkpoint import CheckpointManager

    if not isinstance(ckpt, CheckpointManager):
        ckpt.refuse_other_worlds()
        return False
    if not ckpt.discover_worlds():
        return False
    if launched > 1:
        ckpt.refuse_other_worlds(
            f"the run spans {launched} processes (the LM CLI reshards in "
            "one process)")
    if args.sp > 1:
        ckpt.refuse_other_worlds(
            f"--sp {args.sp} > 1 keeps a replica's sequence shards in "
            "its file, so the files are not one rank row each")
    if args.tp > 1 or args.ep > 1 or args.pp > 1:
        axis, n = next((a, k) for a, k in (
            ("--tp", args.tp), ("--ep", args.ep), ("--pp", args.pp))
            if k > 1)
        ckpt.refuse_other_worlds(
            f"{axis} {n} > 1 (the reference reshards flat dp meshes only)")
    if maybe_cross_world_reshard(args.checkpoint_dir, args.tag, world,
                                 log=log) is None:
        log.warning(f"a checkpoint of world {world} is on disk but "
                    "incomplete; starting from step 0")
        return False
    return ckpt.exists()


def _run_meta(rt, args, state, alg, held: int, interconnect, world: int,
              dp: int) -> None:
    """Attach the comm model (on the flat dp and dp x sp meshes: ep, tp
    and pp shard the leaves past their leading dim, which the per-rank
    payload arithmetic does not cover) and emit the ``run_meta``
    event."""
    from ..parallel.wire import get_codec
    from ..telemetry import (CommModel, encoded_payload_bytes,
                             tree_payload_bytes)

    sb = _str_bool
    if args.pp == 1 and args.ep == 1 and args.tp == 1:
        # one replica's payload: the state stacks the held replicas
        exact = tree_payload_bytes(state.params, held)
        if sb(args.all_reduce):
            model = CommModel.for_allreduce(dp, exact)
        elif sb(args.bilat):
            model = CommModel.for_bilat(dp, exact)
        else:
            # the encoded payload: what the wire ships
            codec = get_codec(args.wire_dtype, args.wire_block)
            model = CommModel.from_schedule(
                alg.schedule, encoded_payload_bytes(state.params, held,
                                                    codec),
                exact_bytes=exact, gossip_every=alg.gossip_every,
                global_avg_every=alg.global_avg_every, faults=alg.faults,
                ps_weight=sb(args.push_sum), interconnect=interconnect,
                codec=codec, error_feedback=sb(args.error_feedback),
                overlap=alg.overlap, staleness=alg.staleness,
                gossip_kernel=alg.transport_kernel_name,
                gossip_buckets=alg.gossip_buckets)
        rt.attach_comm(model)
    run_meta = {
        "world": world, "dp": dp, "sp": args.sp, "tp": args.tp,
        "ep": args.ep, "pp": args.pp,
        "algorithm": ("all_reduce" if sb(args.all_reduce) else
                      "adpsgd" if sb(args.bilat) else
                      "sgp" if sb(args.push_sum) else "dpsgd"),
        "gossip_every": args.gossip_every,
        "batch_size": args.batch_size,
        "num_steps": args.num_steps,
        "comm_model": (rt.comm.model.to_dict()
                       if rt.comm is not None else None)}
    if args.profile_dir:
        # where the torch.profiler trace lands, and its step window
        run_meta["profile_dir"] = args.profile_dir
        run_meta["profile_window"] = [
            args.profile_start_step,
            args.profile_start_step + args.profile_steps]
    if args.fleet:
        run_meta["fleet"] = True
        run_meta["host_id"] = (args.host_id if args.host_id is not None
                               else rt.rank)
    rt.registry.emit("run_meta", run_meta)


def _observe_health(monitor, policy, recovery, alg, state, metrics,
                    steps_done: int, window, val_time: float, rt):
    """Read one step's health signals at the print cadence, observe
    them (one step-time sample per read window, validation's time and
    the first window left out) and fire the policy's global average
    (in a ``recovery_global_average`` span, priced on ``rt``'s comm
    tally); returns ``(state, window)``."""
    from ..resilience.monitor import host_signals
    from ..resilience.recovery import recover_state

    now = time.perf_counter()
    if window is not None and steps_done > window[1]:
        elapsed = (now - window[0]) - (val_time - window[2])
        monitor.record_step_time(max(0.0, elapsed)
                                 / (steps_done - window[1]))
    report = monitor.observe(steps_done, host_signals(metrics))
    if report.unhealthy and policy is not None:
        if policy.assess(report).action == "global-average":
            with rt.span("recovery_global_average", "recovery"):
                state = recover_state(state, alg, recovery)
            if rt.comm is not None:
                rt.comm.on_recovery()
    return state, (now, steps_done, val_time)


if __name__ == "__main__":
    main()
