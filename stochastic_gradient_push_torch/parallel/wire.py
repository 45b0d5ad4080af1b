"""Gossip wire codecs: the single encode path for compressed payloads.

Port of ``stochastic_gradient_push_tpu/parallel/wire.py``: identity
(:data:`F32`), bfloat16 truncation (:data:`BF16`) and symmetric per-block
int8 with float32 scales (:class:`Int8Codec`).  ``encode`` returns the
tuple of tensors that crosses the wire; ``decode`` rebuilds the payload
at the receiver with ``like`` as its shape/dtype template.  The
elementwise op order of ``Int8Codec.encode/decode`` (``wire.py:175,191``
there) is kept, and so is the rounding of the reference's *compiled*
code (XLA on the CPU, which is how the reference's gossip round runs):
the division by the constant 127 is a multiplication by its float32
reciprocal, and a decode followed by an add is one fused multiply-add
(:meth:`WireCodec.decode_add`).  Encoded bytes and decoded values are
bit-equal to the reference's (``tests/test_torch_wire.py``).

One difference of layout: the collectives hand a codec **rank-stacked**
leaves, dim 0 indexing the ranks this process holds (all of them on the
stacked lane, one on the ``torch.distributed`` lane).  The int8 codec
blocks each rank's flattened leaf on its own, exactly as each rank of the
reference does; a single payload is encoded as ``msg[None]``.  A leaf
the port keeps in another layout than the reference (conv and Dense
kernels, ``models/convert.py``) is blocked in the reference's layout:
the collectives hand the codec that view (:class:`ReferenceLayout`), so
every block groups the reference's elements and gets its scale.

Scalar leaves (the push-sum weight lane) never reach a codec: the
collectives ship them exact.  :meth:`WireCodec.kernel_spec` describes a
codec's decode to the gossip kernel lane (``ops/gossip_kernel.py``); a
codec without one (the base default) pins the plain transport lane.
Not ported yet: the deprecated ``comm_dtype`` alias.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["WireCodec", "F32Codec", "BF16Codec", "Int8Codec", "DecodeSpec",
           "ReferenceLayout", "F32", "BF16", "WIRE_DTYPES", "DEFAULT_WIRE_BLOCK",
           "INT8_SCALE_BYTES", "get_codec", "wire_stamp"]

WIRE_DTYPES = ("f32", "bf16", "int8")
DEFAULT_WIRE_BLOCK = 64
# dtype size of the per-block scale lane riding beside the int8 payload
INT8_SCALE_BYTES = 4
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """What the gossip kernel lane needs to decode a codec's wire inside
    the wait kernel: the decode kind (``"f32"`` passthrough, ``"bf16"``
    widen, ``"int8"`` ``q * scale``) and the int8 block."""

    kind: str
    block: int | None = None


class WireCodec:
    """Identity/base codec: the payload ships as-is (one wire part).
    ``blocked`` codecs group elements (int8's per-block scales), so the
    collectives hand them each leaf in the reference's layout
    (:class:`ReferenceLayout`)."""

    name = "f32"
    lossy = False
    blocked = False

    def kernel_spec(self) -> DecodeSpec | None:
        """The decode the gossip kernel lane would run; None (the base
        default) keeps the collectives on the plain transport lane."""
        return None

    def element_bytes(self, n: int, itemsize: int = 4) -> int:
        """Wire bytes of an ``n``-element payload of ``itemsize``."""
        return n * itemsize

    def wire_fraction(self, itemsize: int = 4) -> float:
        """Asymptotic encoded bytes over full-precision bytes: the factor
        the planner prices gossip payloads at (the reference's
        ``WireCodec.wire_fraction``)."""
        n = 1 << 20
        return self.element_bytes(n, itemsize) / float(n * itemsize)

    def encode(self, msg: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return (msg,)

    def decode(self, wire, like: torch.Tensor) -> torch.Tensor:
        del like
        return wire[0]

    def decode_add(self, wire, acc: torch.Tensor) -> torch.Tensor:
        """``acc + decode(wire)``, rounded as the reference's compiled
        round rounds it."""
        return acc + self.decode(wire, acc)

    def error(self, wire, msg: torch.Tensor) -> torch.Tensor:
        """``msg - decode(wire)``: the quantization error error feedback
        carries, rounded as the reference's compiled round rounds it."""
        return msg - self.decode(wire, msg)


class F32Codec(WireCodec):
    """Explicit name for the identity codec (``--wire_dtype f32``)."""

    def kernel_spec(self) -> DecodeSpec:
        return DecodeSpec("f32")


class BF16Codec(WireCodec):
    """Truncate payloads to bfloat16 on the wire (round to nearest even,
    as the reference's ``astype``), widen back at the receiver."""

    name = "bf16"
    lossy = True

    def encode(self, msg):
        return (msg.to(torch.bfloat16),)

    def decode(self, wire, like):
        return wire[0].to(like.dtype)

    def element_bytes(self, n: int, itemsize: int = 4) -> int:
        del itemsize
        return n * 2

    def kernel_spec(self) -> DecodeSpec:
        return DecodeSpec("bf16")


class Int8Codec(WireCodec):
    """Symmetric per-block int8 quantization with f32 scales.

    Each rank's flattened leaf is split into ``block``-element blocks;
    each block ships ``round(x / scale)`` as int8 with ``scale =
    max|x| / 127`` in a float32 side lane.  Symmetric, so ``Q(0) == 0``.
    """

    name = "int8"
    lossy = True
    blocked = True

    def __init__(self, block: int = DEFAULT_WIRE_BLOCK):
        if block < 1:
            raise ValueError(f"wire_block must be >= 1, got {block}")
        self.block = int(block)

    def encode(self, msg):
        ranks = msg.shape[0]
        n = msg[0].numel()
        nb = -(-n // self.block)
        flat = msg.reshape(ranks, -1).to(torch.float32)
        if nb * self.block != n:
            flat = torch.nn.functional.pad(flat, (0, nb * self.block - n))
        blocks = flat.reshape(ranks, nb, self.block)
        amax = blocks.abs().amax(dim=-1)
        # the reference's compiled encode: XLA turns the division by the
        # constant 127 into a multiplication by its float32 reciprocal
        scale = amax * _INV_127
        safe = torch.where(scale > 0.0, scale, 1.0)
        q = torch.clamp(torch.round(blocks / safe[..., None]),
                        -127.0, 127.0).to(torch.int8)
        return (q, scale.to(torch.float32))

    def decode(self, wire, like):
        q, scale = wire
        ranks = like.shape[0]
        flat = (q.to(torch.float32) * scale[..., None]).reshape(ranks, -1)
        return flat[:, :like[0].numel()].reshape(like.shape).to(like.dtype)

    def decode_add(self, wire, acc):
        """``acc + q * scale`` with one rounding (XLA contracts the
        reference's decode-add into a fused multiply-add)."""
        q, scale = wire
        ranks, n = acc.shape[0], acc[0].numel()
        flat = acc.reshape(ranks, -1).to(torch.float32)
        flat = torch.nn.functional.pad(flat, (0, q[0].numel() - n))
        out = torch.addcmul(flat.reshape(q.shape), q.to(torch.float32),
                            scale[..., None])
        return out.reshape(ranks, -1)[:, :n].reshape(acc.shape).to(acc.dtype)

    def error(self, wire, msg):
        """``msg - q * scale`` with one rounding (XLA contracts the
        reference's error into a fused multiply-add).  The code is
        negated (exact) rather than passed ``value=-1``: the CUDA
        ``addcmul`` rounds ``value * t1 * t2`` before the add."""
        q, scale = wire
        ranks, n = msg.shape[0], msg[0].numel()
        flat = msg.reshape(ranks, -1).to(torch.float32)
        flat = torch.nn.functional.pad(flat, (0, q[0].numel() - n))
        out = torch.addcmul(flat.reshape(q.shape), q.to(torch.float32).neg(),
                            scale[..., None])
        return out.reshape(ranks, -1)[:, :n].reshape(msg.shape).to(msg.dtype)

    def element_bytes(self, n: int, itemsize: int = 4) -> int:
        del itemsize
        return n + INT8_SCALE_BYTES * int(math.ceil(n / self.block))

    def kernel_spec(self) -> DecodeSpec:
        return DecodeSpec("int8", block=self.block)


F32 = F32Codec()
BF16 = BF16Codec()


@dataclasses.dataclass(frozen=True)
class ReferenceLayout:
    """Where the reference keeps each of a model's leaves.

    ``order`` is the port's leaf names in the reference's flatten order
    (JAX's sorted-key tree order); ``perms`` maps a leaf whose layout
    differs (a conv kernel, OIHW here and HWIO there; a Dense kernel,
    ``[out, in]`` here and ``[in, out]`` there) to the permutation of its
    dims that gives the reference's layout.  Built by
    ``models/convert.py::reference_layout``; the int8 codec's blocks and
    the health probe read leaves through it."""

    order: tuple = ()
    perms: dict = dataclasses.field(default_factory=dict)

    def perm(self, name: str):
        """The leaf's permutation to the reference's layout, or None."""
        return self.perms.get(name)


def wire_stamp(dtype: str | None, block: int = DEFAULT_WIRE_BLOCK,
               error_feedback: bool = False) -> dict | None:
    """The wire config the planner prices on and a plan records
    (``{"dtype", "block", "error_feedback"}``, the block for int8 only);
    None for the exact wire."""
    if dtype in (None, "f32"):
        return None
    out = {"dtype": dtype}
    if dtype == "int8":
        out["block"] = int(block)
    out["error_feedback"] = bool(error_feedback)
    return out


def get_codec(dtype: str | None,
              block: int = DEFAULT_WIRE_BLOCK) -> WireCodec | None:
    """Resolve a ``--wire_dtype`` flag value into a codec (None for
    unset)."""
    if dtype is None:
        return None
    if dtype == "f32":
        return F32
    if dtype == "bf16":
        return BF16
    if dtype == "int8":
        return Int8Codec(block)
    raise ValueError(f"unknown wire_dtype {dtype!r}; one of {WIRE_DTYPES}")
