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

Two forms.  The **stacked lane**: all ``R`` ranks of the world live in
one process, every tensor carries a leading rank dim (parts and landed
buffers ``[R, E, ...]``, accumulators ``[R, ...]``), and the "remote"
copy writes another rank's rows of the same device memory.  The
**cross-process lane** (:func:`gossip_edge_start_dist`, one rank per
process, ``R = 1``): a :class:`PeerLinks` gives each transport bucket a
landing block per rank, exported by CUDA IPC and mapped by the peers
that send to it (handles passed through the process group's store).
Stream order is the barrier.  K2 (``sgp_gossip_edge_start_ipc``) is a
small kernel that acquires each receiver's ``consumed[e]`` of the
previous round (the TPU kernel's entry barrier), the stacked K2 copying
this rank's encoded edge ``e`` straight into the landing row of
``dests[e][rank]``, and a small kernel that release-stores the round in
the receiver's ``ready[e]``; K1 (``sgp_gossip_edge_wait_ipc_*``) acquires
every incoming ``ready[e]``, runs the stacked K1 and releases
``consumed``.  The start runs on a side stream and hands the wait a
CUDA event, so an overlap start runs beside the step.  Every wait gives up after ``timeout_s``; the host
then raises :class:`PeerLostError` naming the rank, the edge and the
round.  Its plain twin carries the same encoded parts over
``torch.distributed`` ``batch_isend_irecv`` into the receiver's landing
rows and lands them with :func:`gossip_edge_wait_reference`: the CPU
carrier under gloo, and the oracle on the card.

Lanes: a :class:`KernelLane` with ``interpret=True`` is the counterpart
of Pallas interpret mode — the wrappers run the plain twins
(:func:`gossip_edge_start_reference`, :func:`gossip_edge_wait_reference`)
on CPU tensors, which is how the CPU tests drive the kernel lane.  A
non-interpret lane launches the CUDA kernels on CUDA tensors; handed CPU
tensors it raises :class:`~.lanes.KernelLaneError`, and an interpret
lane handed CUDA tensors raises likewise: nothing falls back.  A failed
IPC map on the card raises :class:`KernelBackendError`.

The push-sum weight never enters either kernel: scalar leaves stay on
the collectives' exact lane.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import itertools
import math

import numpy as np
import torch

from . import _build
from .lanes import KernelLaneError

__all__ = ["KernelBackendError", "KernelLane", "GOSSIP_KERNELS",
           "DEFAULT_CHUNK_ELEMS", "COLLECTIVE_ID_SLOTS", "TransportHandle",
           "empty_transport_handle", "resolve_gossip_kernel",
           "gossip_edge_start", "gossip_edge_wait", "gossip_edge_axpy",
           "gossip_edge_start_reference", "gossip_edge_wait_reference",
           "padded_len", "PEER_TIMEOUT_S", "PeerLostError", "PeerLinks",
           "gossip_edge_start_dist", "gossip_edge_start_dist_reference"]

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
_MAX_EDGES = 16           # csrc/gossip_edge.cu MAX_EDGES

# how long a cross-process wait spins (kernel) or blocks (twin) before it
# names the peer that never sent
PEER_TIMEOUT_S = 10.0
_TAG_BASE = 16


class KernelBackendError(RuntimeError):
    """``gossip_kernel="pallas"`` where the CUDA kernels cannot run."""


class PeerLostError(RuntimeError):
    """A cross-process gossip wait passed its limit, or its peer went away:
    the message names this rank, the edge, the round and the peer."""


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
    remote: object = None   # cross-process: the round's _Landing

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


def _check_spec(spec) -> str:
    if spec is None:
        raise ValueError("codec exposes no in-kernel decode spec; the "
                         "caller must take the plain transport lane")
    if spec.kind not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown decode spec kind {spec.kind!r}")
    return spec.kind


def _chunk_parts(parts, spec, n_decoded, chunk_elems):
    """``(chunks, n, rows, C, NB)``: the encoded parts ``[R, E, ...]`` cut
    into the chunk layout (f32/bf16 ``[R, E, NB, C]``; int8 q ``[R, E,
    NB, rows, block]`` and scales ``[R, E, NB, rows]``), zero-padded where
    shorter."""
    ranks, ne = parts[0].shape[:2]
    if spec.kind == "int8":
        q, scale = parts
        n = int(n_decoded) if n_decoded is not None \
            else q.shape[2] * q.shape[3]
        rows, c, nb = _chunk_layout(n, spec.block, chunk_elems)
        return ((_pad_rows(q, nb * rows, 2).reshape(ranks, ne, nb, rows,
                                                    q.shape[3]),
                 _pad_rows(scale, nb * rows, 2).reshape(ranks, ne, nb,
                                                        rows)),
                n, rows, c, nb)
    (w,) = parts
    w = w.reshape(ranks, ne, -1)
    n = int(n_decoded) if n_decoded is not None else w.shape[2]
    rows, c, nb = _chunk_layout(n, None, chunk_elems)
    return (_pad_rows(w, nb * c, 2).reshape(ranks, ne, nb, c),), n, rows, \
        c, nb


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
    kind = _check_spec(spec)
    parts = tuple(parts)
    ranks, ne = parts[0].shape[:2]
    table = _dest_table(dests, ranks)
    if table.shape[0] != ne or any(p.shape[:2] != (ranks, ne)
                                   for p in parts):
        raise ValueError(
            f"parts lead with {[tuple(p.shape[:2]) for p in parts]} (ranks, "
            f"edges) but dests has {table.shape[0]} rows for world {ranks}")
    kernel = _check_lane(parts[0], interpret, "gossip_edge_start")
    chunks, n, rows, c, nb = _chunk_parts(parts, spec, n_decoded,
                                          chunk_elems)
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
    if handle.remote is not None:
        out = handle.remote.land(acc_chunks, handle.recv, kind, kernel)
    elif kernel:
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


# -- the cross-process lane -------------------------------------------------


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr`` as a CUDA array interface,
    so ``torch.as_tensor`` views memory this module allocated or mapped."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (int(nbytes),), "typestr": "|u1",
            "data": (int(ptr), False), "version": 2}


def _align(n: int, to: int = 256) -> int:
    return -(-int(n) // to) * to


def _ipc(rc: int, what: str, rank: int) -> None:
    """Raise :class:`KernelBackendError` for a failed IPC call: the
    cross-process kernel lane never turns into the plain lane."""
    if rc != 0:
        raise KernelBackendError(
            f"cross-process gossip transport, rank {rank}: {what} failed "
            f"with cudaError_t {rc}")


class _Link:
    """One transport bucket's cross-process landing on the card.

    This rank's block ``[ready[E] | consumed[E] | part 0 [E, ...] | part
    1 [E, ...]]`` (u64 counters, parts 256-byte aligned), exported with
    ``cudaIpcGetMemHandle`` (the handle goes to the group's store); a
    peer's block is mapped at the first round that sends to it
    (:meth:`base`), so a process maps only the peers it sends to.
    Local: the abort word and a device int32 0 (the one-rank dests table
    of the stacked K2), and a host-mapped error record ``(code, rank,
    edge, round)``."""

    def __init__(self, peers: "PeerLinks", key: str, shapes, dtypes,
                 device: torch.device):
        lib = _build.load("gossip_edge")
        rank, dev = peers.rank, device.index
        self.peers, self.device, self.lib, self.key = peers, device, lib, key
        self.E = int(shapes[0][0])
        self.offs, off = [], _align(16 * self.E)
        for shape, dt in zip(shapes, dtypes):
            self.offs.append(off)
            off += _align(math.prod(shape) * dt.itemsize)
        self.slabs = [math.prod(shape[1:]) * dt.itemsize
                      for shape, dt in zip(shapes, dtypes)]
        self.nbytes = off
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        _ipc(lib.sgp_gossip_ipc_alloc(dev, off, ctypes.byref(ptr), handle),
             f"cudaMalloc/cudaIpcGetMemHandle of {off} bytes", rank)
        self.ptr = ptr.value
        self.opened: dict = {}   # peer rank -> its block, mapped here
        peers.store().set(peers.handle_key(key, rank), handle.raw)
        host, dptr = ctypes.c_void_p(), ctypes.c_void_p()
        _ipc(lib.sgp_gossip_host_alloc(32, ctypes.byref(host),
                                       ctypes.byref(dptr)),
             "cudaHostAlloc of the error record", rank)
        self.host, self.err_dev = host.value, dptr.value
        self.err = (ctypes.c_longlong * 4).from_address(self.host)
        # the abort word, then the one-rank dests table (0)
        self.local = torch.zeros(2, dtype=torch.int32, device=device)
        mem = torch.as_tensor(_DeviceBytes(self.ptr, off), device=device)
        self.recv = tuple(
            mem[o:o + math.prod(shape) * dt.itemsize].view(dt)
            .reshape((1,) + tuple(shape))
            for o, shape, dt in zip(self.offs, shapes, dtypes))
        self.round = 0
        self.dests: dict = {}   # round -> (dests, sources), for errors

    def base(self, r: int) -> int:
        """Rank ``r``'s block as this process addresses it (mapped from
        its handle at first use)."""
        if r == self.peers.rank:
            return self.ptr
        if r not in self.opened:
            raw = self.peers.store().get(self.peers.handle_key(self.key, r))
            peer = ctypes.c_void_p()
            _ipc(self.lib.sgp_gossip_ipc_open(
                self.device.index, ctypes.create_string_buffer(raw, 64),
                ctypes.byref(peer)), f"cudaIpcOpenMemHandle of rank {r}",
                self.peers.rank)
            self.opened[r] = peer.value
        return self.opened[r]

    def counters(self, bases, which: int):
        """``int64[E]`` addresses of ``ready[e]`` (``which`` 0) or
        ``consumed[e]`` (1) in the block at ``bases[e]``."""
        return (ctypes.c_longlong * self.E)(*(
            b + 8 * (which * self.E + e) for e, b in enumerate(bases)))

    def args(self, rnd: int):
        """The kernels' ``link`` argument for round ``rnd``."""
        return (ctypes.c_longlong * 5)(
            self.local.data_ptr(), self.err_dev, rnd,
            int(self.peers.timeout_s * 1e9), self.peers.rank)

    def check(self) -> None:
        """Raise :class:`PeerLostError` if a wait of this link gave up."""
        code = int(self.err[0])
        if code:
            edge, rnd = int(self.err[2]), int(self.err[3])
            row = self.dests.get(rnd)
            if code == 1:
                peer = "" if row is None else f" (rank {row[0][edge]})"
                what = (f"its receiver{peer} did not consume round "
                        f"{rnd - 1}")
            else:
                peer = "" if row is None else f" from rank {row[1][edge]}"
                what = f"no payload{peer} arrived"
            raise PeerLostError(
                f"cross-process gossip: rank {self.peers.rank}, edge "
                f"{edge}, round {rnd}: {what} within "
                f"{self.peers.timeout_s} s")

    def close(self) -> None:
        rank, dev = self.peers.rank, self.device.index
        for ptr in self.opened.values():
            _ipc(self.lib.sgp_gossip_ipc_close(dev, ptr),
                 "cudaIpcCloseMemHandle", rank)
        _ipc(self.lib.sgp_gossip_free(dev, self.ptr), "cudaFree", rank)
        _ipc(self.lib.sgp_gossip_host_free(self.host), "cudaFreeHost", rank)
        self.opened, self.recv = {}, ()


@dataclasses.dataclass
class _Landing:
    """One cross-process round in flight: kernel (``link``, the start's
    ``event``) or twin (the ``works`` with their edges and peers, and
    host buffers to copy back)."""

    peers: "PeerLinks"
    rnd: int
    link: _Link | None = None
    event: object = None
    works: list = dataclasses.field(default_factory=list)
    copies: list = dataclasses.field(default_factory=list)

    def land(self, acc, recv, kind: str, kernel: bool):
        if self.link is None:
            self._wait_works()
            return gossip_edge_wait_reference(acc, recv, kind)
        link = self.link
        link.check()
        torch.cuda.current_stream(acc.device).wait_event(self.event)
        out = torch.empty_like(acc)
        lib, length = link.lib, acc[0].numel()
        own = [link.ptr] * link.E
        args = (link.E, link.counters(own, 0), link.counters(own, 1),
                link.args(self.rnd), acc.device.index, _build.stream(acc))
        if kind == "int8":
            rc = lib.sgp_gossip_edge_wait_ipc_int8(
                acc.data_ptr(), recv[0].data_ptr(), recv[1].data_ptr(),
                out.data_ptr(), length, recv[0].shape[-1], *args)
        else:
            fn = (lib.sgp_gossip_edge_wait_ipc_bf16 if kind == "bf16"
                  else lib.sgp_gossip_edge_wait_ipc_f32)
            rc = fn(acc.data_ptr(), recv[0].data_ptr(), out.data_ptr(),
                    length, *args)
        gossip_edge_wait.launches_ipc += 1
        _build.check(rc, "gossip_edge_wait (cross-process)")
        return out

    def _wait_works(self) -> None:
        timeout = datetime.timedelta(seconds=self.peers.timeout_s)
        rank = self.peers.rank
        for work, edge, peer, sending in self.works:
            try:
                work.wait(timeout)
            except RuntimeError as e:
                what = (f"rank {peer} did not take its payload" if sending
                        else f"no payload from rank {peer} arrived")
                raise PeerLostError(
                    f"cross-process gossip: rank {rank}, edge {edge}, round "
                    f"{self.rnd}: {what} within {self.peers.timeout_s} s "
                    f"({e})") from None
        for host, dev in self.copies:
            dev.copy_(host)
        self.works, self.copies = [], []


class PeerLinks:
    """This process's end of the cross-process gossip transport (one rank
    per process of a ``torch.distributed`` group: ``group``, None for the
    default one).  ``rank`` and ``world`` are the group's (gossip ranks);
    ``members[r]`` is the global rank of the process holding gossip rank
    ``r`` (default: the identity), under which its handles are published,
    so the gossip groups of several shard indices, running side by side,
    never map each other's blocks.

    On the card, one :class:`_Link` per transport bucket, made at its
    first round by every process in the same order (each publishes its
    block's handle in the group's store), and one side stream for the
    starts.  Nothing caps the world: a process maps only the blocks of
    the ranks it sends to.  On the CPU
    (the twin) nothing is allocated; rounds are counted per bucket all
    the same, so errors name them alike.  ``timeout_s`` bounds every
    wait.  :meth:`check` raises a wait that gave up; :meth:`close` frees
    the blocks once every process is done with them."""

    _made = itertools.count()

    def __init__(self, rank: int, world: int,
                 timeout_s: float = PEER_TIMEOUT_S, members=None,
                 group=None):
        self.rank, self.world = int(rank), int(world)
        self.members = (list(range(self.world)) if members is None
                        else [int(m) for m in members])
        if len(self.members) != self.world:
            raise ValueError(f"{len(self.members)} members for a group of "
                             f"{self.world}")
        self.group = group
        self.timeout_s = float(timeout_s)
        self.name = f"sgp_gossip_ipc/{next(self._made)}"
        self.links: dict = {}
        self.rounds: dict = {}
        self.stream = None

    @staticmethod
    def store():
        import torch.distributed as dist

        return dist.distributed_c10d._get_default_store()

    def handle_key(self, link: str, r: int) -> str:
        """The store key of gossip rank ``r``'s block handle on ``link``:
        named by the process that holds it."""
        return f"{link}/{self.members[r]}"

    def _link(self, slot, chunks) -> _Link:
        shapes = tuple(tuple(p.shape[1:]) for p in chunks)
        key = (slot, shapes, tuple(p.dtype for p in chunks))
        link = self.links.get(key)
        if link is None:
            link = _Link(self, f"{self.name}/{len(self.links)}", shapes,
                         key[2], chunks[0].device)
            self.links[key] = link
            if self.stream is None:
                self.stream = torch.cuda.Stream(chunks[0].device)
        return link

    def start(self, chunks, table: np.ndarray, slot, kernel: bool
              ) -> _Landing:
        """Start one round of bucket ``slot``: on the card, K2 moves
        ``chunks`` (``[1, E, ...]`` in the chunk layout) to
        ``dests[e][rank]`` on the side stream; off it (``kernel`` False)
        the round is only counted, for the twin to fill.  Returns the
        round's :class:`_Landing`."""
        ne = chunks[0].shape[1]
        if ne > _MAX_EDGES:
            raise ValueError(f"at most {_MAX_EDGES} edges a round, got {ne}")
        if not kernel:
            rnd = self.rounds[slot] = self.rounds.get(slot, 0) + 1
            return _Landing(self, rnd)
        src = [int(np.flatnonzero(row == self.rank)[0]) for row in table]
        dst = [int(row[self.rank]) for row in table]
        link = self._link(slot, chunks)
        link.check()
        link.round += 1
        rnd = link.round
        link.dests[rnd] = (dst, src)
        link.dests.pop(rnd - 4, None)
        device = chunks[0].device
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(device))
        bases = [link.base(d) for d in dst]
        args = []
        for i in range(2):
            if i < len(chunks):
                p = chunks[i]
                rows = (ctypes.c_longlong * ne)(*(
                    b + link.offs[i] + e * link.slabs[i]
                    for e, b in enumerate(bases)))
                args += [p.data_ptr(), p[0, 0].numel(), p.element_size(),
                         rows]
            else:
                args += [None, 0, 0, None]
        rc = link.lib.sgp_gossip_edge_start_ipc(
            *args, link.local.data_ptr() + 4, ne, link.counters(bases, 1),
            link.counters(bases, 0), link.args(rnd), device.index,
            side.cuda_stream)
        gossip_edge_start.launches_ipc += 1
        _build.check(rc, "gossip_edge_start (cross-process)")
        for p in chunks:
            p.record_stream(side)
        event = torch.cuda.Event(enable_timing=True)   # K2's end, timed
        event.record(side)
        return _Landing(self, rnd, link=link, event=event)

    def check(self) -> None:
        """Raise :class:`PeerLostError` for any wait that gave up (read
        from host-mapped records: no device sync)."""
        for link in self.links.values():
            link.check()

    def close(self) -> None:
        """Free this rank's blocks and unmap its peers' (a barrier first:
        no peer may still write into them)."""
        if not self.links:
            return
        import torch.distributed as dist

        torch.cuda.synchronize()
        dist.barrier(group=self.group)
        for link in self.links.values():
            link.close()
        self.links = {}


def gossip_edge_start_dist_reference(chunks, table: np.ndarray, rank: int,
                                     landing: _Landing) -> tuple:
    """Plain cross-process transport: every part of edge ``e`` to
    ``dests[e][rank]`` and the matching receive from the rank whose edge
    ``e`` lands here, one ``batch_isend_irecv`` (tag ``16 + 2 e + part``,
    clear of the transport's own permutes) into
    fresh landing rows ``[1, E, ...]``; a rank the permutation fixes
    copies locally.  The works go to ``landing``, which waits them (with
    its timeout) when the round lands.  ``rank`` and the table are in
    the gossip ranks of ``landing.peers``' group; the messages go to the
    processes holding them.  CUDA tensors cross a gloo group through host
    copies."""
    import torch.distributed as dist

    peers = landing.peers
    staged = (chunks[0].is_cuda
              and dist.get_backend(peers.group) == dist.Backend.GLOO)
    landed = tuple(torch.empty_like(p) for p in chunks)
    ops, meta = [], []
    for e, row in enumerate(table):
        dst = int(row[rank])
        src = int(np.flatnonzero(row == rank)[0])
        for i, (p, out) in enumerate(zip(chunks, landed)):
            if dst == rank:
                out[0, e].copy_(p[0, e])
                continue
            send, recv = p[0, e], out[0, e]
            if staged:
                send, recv = send.cpu(), torch.empty(
                    recv.shape, dtype=recv.dtype)
                landing.copies.append((recv, out[0, e]))
            tag = _TAG_BASE + 2 * e + i
            ops += [dist.P2POp(dist.isend, send, peers.members[dst],
                               peers.group, tag=tag),
                    dist.P2POp(dist.irecv, recv, peers.members[src],
                               peers.group, tag=tag)]
            meta += [(e, dst, True), (e, src, False)]
    if ops:
        for work, (e, peer, sending) in zip(dist.batch_isend_irecv(ops),
                                            meta):
            landing.works.append((work, e, peer, sending))
    return landed


def gossip_edge_start_dist(parts, dests, spec, peers: PeerLinks, slot=0,
                           n_decoded: int | None = None,
                           interpret: bool = False,
                           chunk_elems: int = DEFAULT_CHUNK_ELEMS
                           ) -> TransportHandle:
    """The cross-process :func:`gossip_edge_start`: this rank's encoded
    parts (``[1, E, ...]``, as the stacked lane's rows) to
    ``dests[e][rank]`` through ``peers``, transport bucket ``slot``.
    CUDA tensors on a non-interpret lane launch K2 over the peers' mapped
    landing blocks (one more in ``gossip_edge_start.launches_ipc``); CPU
    tensors on an interpret lane run the twin over ``torch.distributed``.
    The handle's wait (:func:`gossip_edge_wait`) lands it."""
    kind = _check_spec(spec)
    parts = tuple(parts)
    table = _dest_table(dests, peers.world)
    ne = table.shape[0]
    if any(p.shape[:2] != (1, ne) for p in parts):
        raise ValueError(
            f"parts lead with {[tuple(p.shape[:2]) for p in parts]}; the "
            f"cross-process lane takes this rank's (1, {ne}) rows")
    kernel = _check_lane(parts[0], interpret, "gossip_edge_start_dist")
    chunks, n, rows, c, nb = _chunk_parts(parts, spec, n_decoded,
                                          chunk_elems)
    chunks = tuple(p.contiguous() for p in chunks)
    landing = peers.start(chunks, table, slot, kernel)
    if kernel:
        recv = landing.link.recv
    else:
        recv = gossip_edge_start_dist_reference(chunks, table, peers.rank,
                                                landing)
    return TransportHandle(recv=recv,
                           meta=(kind, n, rows, c, nb, ne, bool(interpret)),
                           remote=landing)


gossip_edge_start.launches_ipc = 0
gossip_edge_wait.launches_ipc = 0
