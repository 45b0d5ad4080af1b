"""The gossip transport: edge start (K2) and edge wait (K1), with their
plain twins.

Port of ``stochastic_gradient_push_tpu/ops/gossip_kernel.py``.  A push-sum
round's payload leaves, once encoded (``parallel/wire.py``) and packed
into transport buckets (``parallel/collectives.py``), cross the wire
through two calls:

* :func:`gossip_edge_start` moves every encoded wire part of ``E`` edges
  to the destination rank's landing buffer and returns a
  :class:`TransportHandle` over the landed *encoded* bytes.  It launches
  ``sgp_gossip_edge_start`` of ``csrc/gossip_edge.cu`` (replaces
  ``_edge_start_kernel:295``);
* :func:`gossip_edge_wait` lands a handle: ``acc + Σ_e decode(recv[e])``,
  edges folded in order, through ``sgp_gossip_edge_wait_{f32,bf16,int8}``
  (replaces ``_edge_wait_kernel:513``).

This is the **stacked lane**: all ``R`` ranks of the world live in one
process, every tensor carries a leading rank dim (parts and landed
buffers ``[R, E, ...]``, accumulators ``[R, ...]``), and the "remote"
copy writes another rank's rows of the same device memory.  The
cross-process form (one rank per GPU) is not ported; the collectives
refuse it by name.

Lanes: a :class:`KernelLane` with ``interpret=True`` is the counterpart
of Pallas interpret mode — the wrappers run the plain twins
(:func:`gossip_edge_start_reference`, :func:`gossip_edge_wait_reference`)
on CPU tensors, which is how the CPU tests drive the kernel lane.  A
non-interpret lane launches the CUDA kernels on CUDA tensors; handed CPU
tensors it raises :class:`~.lanes.KernelLaneError`, and an interpret
lane handed CUDA tensors raises likewise: nothing falls back.

The push-sum weight never enters either kernel: scalar leaves stay on
the collectives' exact lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from .lanes import KernelLaneError

__all__ = ["KernelBackendError", "KernelLane", "GOSSIP_KERNELS",
           "DEFAULT_CHUNK_ELEMS", "COLLECTIVE_ID_SLOTS", "TransportHandle",
           "empty_transport_handle", "resolve_gossip_kernel",
           "gossip_edge_start", "gossip_edge_wait", "gossip_edge_axpy",
           "gossip_edge_start_reference", "gossip_edge_wait_reference",
           "padded_len"]

# CLI vocabulary for --gossip_kernel
GOSSIP_KERNELS = ("auto", "pallas", "xla")

# decoded elements per chunk of the transport layout (the reference's
# VMEM-sized target; here it only fixes the zero padding of a payload)
DEFAULT_CHUNK_ELEMS = 64 * 1024

# ceiling on chunks per payload; larger payloads get larger chunks
_MAX_CHUNKS = 256

# the reference cycles its barrier-semaphore ids through this pool per
# transport bucket; kept for the layout, unused on the stacked lane
COLLECTIVE_ID_SLOTS = 16

_MAX_RANK_EDGES = 65535   # the kernels' grid.y


class KernelBackendError(RuntimeError):
    """``gossip_kernel="pallas"`` where the CUDA kernels cannot run."""


@dataclasses.dataclass(frozen=True)
class KernelLane:
    """The resolved kernel lane of the gossip collectives (``None`` is
    the plain transport lane).  ``interpret`` runs the kernels' plain
    twins on CPU tensors."""

    interpret: bool = False
    chunk_elems: int = DEFAULT_CHUNK_ELEMS

    @property
    def name(self) -> str:
        return "pallas"


def resolve_gossip_kernel(flag, interpret: bool = False,
                          device=None) -> KernelLane | None:
    """Map the ``--gossip_kernel`` flag onto a lane.

    ``"xla"``/``None`` → ``None`` (the plain transport lane).  ``"auto"``
    → a :class:`KernelLane` when the kernels can run (a CUDA ``device``,
    or a card present when no device is named) or ``interpret`` is set,
    else ``None``.  ``"pallas"`` → a lane, or :class:`KernelBackendError`
    where neither holds.  An already-resolved lane passes through."""
    if isinstance(flag, KernelLane):
        return flag
    if flag is None or flag == "xla":
        return None
    if flag not in GOSSIP_KERNELS:
        raise ValueError(
            f"unknown gossip_kernel {flag!r}; one of {GOSSIP_KERNELS}")
    card = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    if card or interpret:
        return KernelLane(interpret=bool(interpret))
    if flag == "auto":
        return None
    raise KernelBackendError(
        "gossip_kernel='pallas' needs a CUDA device: the gossip kernels "
        "(csrc/gossip_edge.cu) run only on the card (device: "
        f"{'none' if device is None else device}).  Use gossip_kernel="
        "'xla' or 'auto' for the plain transport lane, or "
        "KernelLane(interpret=True) (tests) for the kernels' plain twins")


# -- chunk layout -----------------------------------------------------------


def _chunk_layout(n_decoded: int, block: int | None, chunk_elems: int):
    """(chunk_rows R, elems per chunk C, num chunks NB) for a payload of
    ``n_decoded`` elements.  With an int8 ``block`` a chunk is a whole
    number of codec blocks so every scale stays chunk-local; the chunk
    target grows when the payload would otherwise exceed the semaphore
    ceiling."""
    if int(n_decoded) < 1:
        raise ValueError(
            f"payload must have at least one element, got {n_decoded} "
            "(scalar/empty leaves take the exact-f32 ppermute lane, "
            "never the kernel)")
    if int(chunk_elems) < 1:
        raise ValueError(f"chunk_elems must be >= 1, got {chunk_elems}")
    blk = int(block) if block else 1
    rows_total = max(1, -(-n_decoded // blk))   # ceil: codec blocks
    # a chunk never exceeds the payload: padding is bounded by one
    # chunk's ragged tail, not by the chunk target
    rows_per_chunk = max(1, min(int(chunk_elems) // blk, rows_total))
    nb = -(-rows_total // rows_per_chunk)
    if nb > _MAX_CHUNKS:
        rows_per_chunk = -(-rows_total // _MAX_CHUNKS)
        nb = -(-rows_total // rows_per_chunk)
    return rows_per_chunk, rows_per_chunk * blk, nb


def _pad_rows(a: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """Zero-pad dim ``dim`` to ``rows`` (symmetric codecs keep decode(0)
    == 0, so padding never leaks into the axpy)."""
    if a.shape[dim] == rows:
        return a
    shape = list(a.shape)
    shape[dim] = rows
    out = a.new_zeros(shape)
    out.narrow(dim, 0, a.shape[dim]).copy_(a)
    return out


def padded_len(spec, n_decoded: int,
               chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> int:
    """Elements of one rank-edge slab after chunk padding: the length a
    caller packs into so :func:`gossip_edge_start` needs no pad copy."""
    rows, c, nb = _chunk_layout(n_decoded,
                                spec.block if spec.kind == "int8" else None,
                                chunk_elems)
    return nb * c


# -- the transport handle ---------------------------------------------------


@dataclasses.dataclass
class TransportHandle:
    """Result of :func:`gossip_edge_start`: the landed encoded receive
    buffers, rank-stacked and chunked (f32/bf16 ``[R, E, NB, C]``; int8
    q ``[R, E, NB, rows, block]`` and scales ``[R, E, NB, rows]``), plus
    the static layout ``meta = (kind, n_decoded, rows, C, NB, E,
    interpret)``.  Between a start and its wait the buffers hold wire
    bytes: only :func:`gossip_edge_wait` and :meth:`decode_edges`
    interpret them."""

    recv: tuple
    meta: tuple

    @property
    def num_edges(self) -> int:
        return self.meta[5]

    @property
    def n_decoded(self) -> int:
        return self.meta[1]

    def decode_edges(self) -> torch.Tensor:
        """Per-edge decoded payload ``[R, E, n]`` in f32, the wait
        kernel's decode in plain PyTorch.  Fold the edges in order to
        match the kernel."""
        kind, n, *_ = self.meta
        ranks, ne = self.recv[0].shape[:2]
        if kind == "int8":
            q, scale = self.recv
            dec = q.to(torch.float32) * scale[..., None]
        else:
            dec = self.recv[0].to(torch.float32)
        return dec.reshape(ranks, ne, -1)[:, :, :n]


def empty_transport_handle(spec, n_decoded: int, num_edges: int,
                           ranks: int, interpret: bool = False,
                           chunk_elems: int = DEFAULT_CHUNK_ELEMS,
                           device=None) -> TransportHandle:
    """A zero handle shaped as a matching :func:`gossip_edge_start` call
    would return it; waiting it lands zero (decode(0) == 0)."""
    kind = spec.kind
    block = spec.block if kind == "int8" else None
    rows, c, nb = _chunk_layout(n_decoded, block, chunk_elems)
    lead = (ranks, num_edges, nb)
    if kind == "int8":
        recv = (torch.zeros(lead + (rows, int(block)), dtype=torch.int8,
                            device=device),
                torch.zeros(lead + (rows,), dtype=torch.float32,
                            device=device))
    else:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        recv = (torch.zeros(lead + (c,), dtype=dtype, device=device),)
    return TransportHandle(recv=recv, meta=(kind, int(n_decoded), rows, c, nb,
                                            int(num_edges), bool(interpret)))


# -- lane checks and the destination table -----------------------------------


def _check_lane(x: torch.Tensor, interpret: bool, name: str) -> bool:
    """True to launch the kernel: CUDA tensors on a non-interpret lane.
    CPU tensors on an interpret lane run the plain twin; any other pair
    raises :class:`~.lanes.KernelLaneError`."""
    if x.is_cuda and not interpret:
        return True
    if not x.is_cuda and interpret:
        return False
    if interpret:
        raise KernelLaneError(
            f"{name}: an interpret lane runs the plain twins on CPU "
            f"tensors only; got a tensor on {x.device}")
    raise KernelLaneError(
        f"{name}: the kernel lane takes CUDA tensors only; got a tensor on "
        f"{x.device} (use KernelLane(interpret=True) for the plain twins)")


def _dest_table(dests, world: int) -> np.ndarray:
    """``dests`` as an int32 ``[E, world]`` table, every row checked to
    be a permutation of the ranks (every rank receives one stream)."""
    table = np.asarray(dests, dtype=np.int32)
    if table.ndim == 1:
        table = table[None]
    if table.ndim != 2 or table.shape[1] != world:
        raise ValueError(f"dests must be [E, {world}] (one destination per "
                         f"rank and edge), got shape {table.shape}")
    for row in table:
        if not np.array_equal(np.sort(row), np.arange(world)):
            raise ValueError(
                "dests must be a permutation of the axis ranks (every "
                f"rank receives exactly one stream); got {row.tolist()}")
    return table


_DEVICE_TABLES: dict = {}


def _device_table(table: np.ndarray, device) -> torch.Tensor:
    """The destination table on the card, made once per schedule phase
    (keyed by its bytes) and reused by every later round."""
    key = (table.tobytes(), table.shape, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(table)).to(device)
        _DEVICE_TABLES[key] = t
    return t


# -- the plain twins --------------------------------------------------------


def gossip_edge_start_reference(parts, dests) -> tuple:
    """Plain transport: ``landed[dests[e][r], e] = parts[r, e]`` for every
    wire part (each ``[R, E, ...]``), as ``index_select`` over the ranks
    with each edge's inverse permutation."""
    parts = tuple(parts)
    table = _dest_table(dests, parts[0].shape[0])
    landed = []
    for p in parts:
        out = torch.empty_like(p)
        for e, row in enumerate(table):
            src = torch.as_tensor(np.argsort(row), device=p.device)
            out[:, e] = p[:, e].index_select(0, src)
        landed.append(out)
    return tuple(landed)


def gossip_edge_wait_reference(acc: torch.Tensor, recv, kind: str
                               ) -> torch.Tensor:
    """Plain landing: ``acc`` f32 ``[R, NB, C]`` plus each edge's decoded
    chunk, edges in order; ``dec = q * scale`` then ``acc + dec``, each
    rounded (the TPU kernel's rounding)."""
    ranks, ne = recv[0].shape[:2]
    out = acc
    for e in range(ne):
        if kind == "int8":
            q, scale = recv
            dec = q[:, e].to(torch.float32) * scale[:, e][..., None]
        else:
            dec = recv[0][:, e].to(torch.float32)
        out = out + dec.reshape(acc.shape)
    return out


# -- the kernel wrappers ----------------------------------------------------


def _launch_start(chunks, landed, table: np.ndarray) -> None:
    ranks, ne = chunks[0].shape[:2]
    if ranks * ne > _MAX_RANK_EDGES:
        raise ValueError(f"ranks*edges {ranks * ne} above {_MAX_RANK_EDGES}")
    for x in (*chunks, *landed):
        if not x.is_contiguous() or x.device != chunks[0].device:
            raise ValueError("gossip_edge_start takes contiguous parts on "
                             "one device")
    dev_table = _device_table(table, chunks[0].device)
    args = []
    for i in range(2):
        if i < len(chunks):
            p = chunks[i]
            args += [p.data_ptr(), landed[i].data_ptr(), p[0, 0].numel(),
                     p.element_size()]
        else:
            args += [None, None, 0, 0]
    lib = _build.load("gossip_edge")
    rc = lib.sgp_gossip_edge_start(*args, dev_table.data_ptr(), ranks, ne,
                                   _build.stream(chunks[0]))
    gossip_edge_start.launches += 1
    _build.check(rc, "gossip_edge_start")


def gossip_edge_start(parts, dests, spec, n_decoded: int | None = None,
                      interpret: bool = False,
                      chunk_elems: int = DEFAULT_CHUNK_ELEMS
                      ) -> TransportHandle:
    """Move every edge's encoded payload to its destination rank; returns
    the :class:`TransportHandle` whose :func:`gossip_edge_wait` decodes
    and accumulates.

    ``parts`` are the encoded wire parts (``WireCodec.encode`` output,
    sender multiply already applied), rank-stacked with the edges next:
    f32/bf16 ``[R, E, n]``; int8 q ``[R, E, n_rows, block]`` and scales
    ``[R, E, n_rows]``.  A part already padded to the chunk layout (see
    :func:`padded_len`) is used as is; a shorter one is zero-padded.
    ``dests`` is the ``[E, world]`` destination table, each row a
    permutation; ``R`` must be the world.  ``n_decoded`` is the payload
    length the wait trims to (default: the encoded capacity).  Adds one
    to ``gossip_edge_start.launches`` per kernel launch."""
    if spec is None:
        raise ValueError("codec exposes no in-kernel decode spec; the "
                         "caller must take the plain transport lane")
    kind = spec.kind
    if kind not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown decode spec kind {kind!r}")
    parts = tuple(parts)
    ranks, ne = parts[0].shape[:2]
    table = _dest_table(dests, ranks)
    if table.shape[0] != ne or any(p.shape[:2] != (ranks, ne)
                                   for p in parts):
        raise ValueError(
            f"parts lead with {[tuple(p.shape[:2]) for p in parts]} (ranks, "
            f"edges) but dests has {table.shape[0]} rows for world {ranks}")
    kernel = _check_lane(parts[0], interpret, "gossip_edge_start")
    if kind == "int8":
        q, scale = parts
        n = int(n_decoded) if n_decoded is not None \
            else q.shape[2] * q.shape[3]
        rows, c, nb = _chunk_layout(n, spec.block, chunk_elems)
        chunks = (_pad_rows(q, nb * rows, 2).reshape(ranks, ne, nb, rows,
                                                     q.shape[3]),
                  _pad_rows(scale, nb * rows, 2).reshape(ranks, ne, nb,
                                                         rows))
    else:
        (w,) = parts
        w = w.reshape(ranks, ne, -1)
        n = int(n_decoded) if n_decoded is not None else w.shape[2]
        rows, c, nb = _chunk_layout(n, None, chunk_elems)
        chunks = (_pad_rows(w, nb * c, 2).reshape(ranks, ne, nb, c),)
    if kernel:
        landed = tuple(torch.empty_like(p) for p in chunks)
        _launch_start(chunks, landed, table)
    else:
        landed = gossip_edge_start_reference(chunks, table)
    return TransportHandle(recv=landed,
                           meta=(kind, n, rows, c, nb, ne, bool(interpret)))


gossip_edge_start.launches = 0


def _launch_wait(kind: str, acc, recv, out, block: int) -> None:
    ranks, ne = recv[0].shape[:2]
    for x in (acc, out, *recv):
        if not x.is_contiguous() or x.device != acc.device:
            raise ValueError("gossip_edge_wait takes contiguous tensors on "
                             "one device")
    want = {"f32": (torch.float32,), "bf16": (torch.bfloat16,),
            "int8": (torch.int8, torch.float32)}[kind]
    if acc.dtype != torch.float32 or tuple(x.dtype for x in recv) != want:
        raise TypeError(f"{kind} wait takes a float32 accumulator and "
                        f"{want} wire parts, got {acc.dtype} and "
                        f"{tuple(x.dtype for x in recv)}")
    length = acc[0].numel()
    lib = _build.load("gossip_edge")
    stream = _build.stream(acc)
    if kind == "int8":
        rc = lib.sgp_gossip_edge_wait_int8(
            acc.data_ptr(), recv[0].data_ptr(), recv[1].data_ptr(),
            out.data_ptr(), length, block, ranks, ne, stream)
    else:
        fn = (lib.sgp_gossip_edge_wait_bf16 if kind == "bf16"
              else lib.sgp_gossip_edge_wait_f32)
        rc = fn(acc.data_ptr(), recv[0].data_ptr(), out.data_ptr(), length,
                ranks, ne, stream)
    gossip_edge_wait.launches += 1
    _build.check(rc, "gossip_edge_wait")


def gossip_edge_wait(handle: TransportHandle,
                     acc: torch.Tensor) -> torch.Tensor:
    """Land a started transport: ``acc + Σ_e decode(recv[:, e])``, edges
    in order, for a rank-stacked f32 ``acc`` ``[R, ...]`` whose per-rank
    size is the handle's payload (or its padded length).  Returns a new
    tensor shaped like ``acc``.  Adds one to ``gossip_edge_wait.launches``
    per kernel launch."""
    kind, n, rows, c, nb, ne, interpret = handle.meta
    ranks = acc.shape[0]
    per_rank = acc[0].numel()
    if per_rank not in (n, nb * c):
        raise ValueError(
            f"accumulator has {per_rank} elements per rank but the "
            f"transport handle landed a {n}-element payload")
    if handle.recv[0].shape[0] != ranks:
        raise ValueError(f"accumulator holds {ranks} ranks, the handle "
                         f"{handle.recv[0].shape[0]}")
    kernel = _check_lane(acc, interpret, "gossip_edge_wait")
    acc_chunks = _pad_rows(acc.reshape(ranks, per_rank), nb * c, 1
                           ).reshape(ranks, nb, c)
    if kernel:
        out = torch.empty_like(acc_chunks)
        block = handle.recv[0].shape[-1] if kind == "int8" else 1
        _launch_wait(kind, acc_chunks, handle.recv, out, block)
    else:
        out = gossip_edge_wait_reference(acc_chunks, handle.recv, kind)
    return out.reshape(ranks, nb * c)[:, :per_rank].reshape(acc.shape)


gossip_edge_wait.launches = 0


def gossip_edge_axpy(acc, parts, dests, spec, interpret: bool = False,
                     chunk_elems: int = DEFAULT_CHUNK_ELEMS):
    """``acc + decode(permute(parts))``: a :func:`gossip_edge_start`
    consumed at once by its :func:`gossip_edge_wait`."""
    handle = gossip_edge_start(parts, dests, spec,
                               n_decoded=acc[0].numel(), interpret=interpret,
                               chunk_elems=chunk_elems)
    return gossip_edge_wait(handle, acc)
