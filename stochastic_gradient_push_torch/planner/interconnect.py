"""Torus-aware interconnect cost model: ICI hops inside a slice, DCN across.

The planner's original comm model priced every edge as a 1-D ring hop on
a uniform fabric.  A real pod is two fabrics: inside a slice, messages
ride the ICI torus and cost per-byte roughly proportional to the torus
hop distance; between slices they cross DCN, which is an order of
magnitude more expensive per byte and — being packet-switched — flat in
distance.  This module prices one directed edge under that model:

* ``src == dst``                →  0 (loopback padding edges are free);
* same slice                    →  ``ici_cost × torus_hops(src, dst)``
  where the hop distance is measured on the slice's 2-D/3-D torus
  (``torus`` dims; default a 1-D ring over the slice);
* different slices              →  ``dcn_cost`` (flat per crossing).

With no slice structure (``slice_size=None``) the whole world is one
torus and the model degenerates to the original ring-hop pricing —
:data:`UNIFORM` is the scorer's default, so rankings on a uniform fabric
are unchanged by construction.

Costs are *relative per-byte link weights* (ICI hop = 1.0); absolute
bandwidth cancels out of a ranking.  The default DCN weight is 16.  The
slice/ICI/DCN vocabulary is the reference's: on GPUs read "slice" as
the NVLink domain and "DCN" as the network between nodes.

A copy of ``stochastic_gradient_push_tpu/planner/interconnect.py``
(stdlib only).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["InterconnectModel", "DEFAULT_DCN_COST", "DEFAULT_ICI_COST",
           "UNIFORM", "make_interconnect"]

DEFAULT_ICI_COST = 1.0
DEFAULT_DCN_COST = 16.0


@dataclasses.dataclass(frozen=True)
class InterconnectModel:
    """Relative per-byte cost of one directed message between two ranks.

    Args:
      slice_size: ranks per ICI slice (contiguous blocks; rank ``r`` is
        in slice ``r // slice_size``).  None = single uniform fabric.
      ici_cost: per-byte weight of one intra-slice torus hop.
      dcn_cost: per-byte weight of one inter-slice (DCN) message.
      torus: intra-slice torus dimensions, e.g. ``(4, 4)`` for a 16-chip
        2-D slice; product must equal ``slice_size`` (or the world, for
        a uniform fabric sized at :meth:`edge_cost` time).  None = 1-D
        ring.
    """

    slice_size: int | None = None
    ici_cost: float = DEFAULT_ICI_COST
    dcn_cost: float = DEFAULT_DCN_COST
    torus: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.slice_size is not None and self.slice_size < 1:
            raise ValueError(f"slice_size must be >= 1; got "
                             f"{self.slice_size}")
        if self.ici_cost <= 0 or self.dcn_cost <= 0:
            raise ValueError("link costs must be positive")
        if self.torus is not None:
            dims = tuple(int(d) for d in self.torus)
            if any(d < 1 for d in dims):
                raise ValueError(f"torus dims must be >= 1; got {dims}")
            if self.slice_size is not None \
                    and math.prod(dims) != self.slice_size:
                raise ValueError(
                    f"torus dims {dims} do not tile slice_size="
                    f"{self.slice_size}")
            object.__setattr__(self, "torus", dims)

    # -- geometry ----------------------------------------------------------

    def slice_of(self, rank: int) -> int:
        return rank // self.slice_size if self.slice_size else 0

    def is_cross_slice(self, src: int, dst: int) -> bool:
        """Does the edge leave its ICI slice (i.e. ride DCN)?"""
        return self.slice_size is not None \
            and self.slice_of(src) != self.slice_of(dst)

    def torus_hops(self, src: int, dst: int, world: int) -> int:
        """Shortest-path link traversals between two same-domain ranks
        on the torus (per-dimension wrap-around ``min(d, dim - d)``)."""
        domain = self.slice_size or world
        a, b = src % domain, dst % domain
        dims = self.torus or (domain,)
        if math.prod(dims) != domain:
            # slice_size-tiled dims are checked at construction; a uniform
            # fabric's torus can only be checked here, once world is known
            raise ValueError(f"torus dims {dims} do not tile the uniform "
                             f"fabric of {domain} ranks")
        hops = 0
        for dim in reversed(dims):   # C-order unravel, minor dim last
            da, db = a % dim, b % dim
            d = abs(da - db)
            hops += min(d, dim - d)
            a //= dim
            b //= dim
        return hops

    # -- pricing -----------------------------------------------------------

    def edge_cost(self, src: int, dst: int, world: int) -> float:
        """Relative per-byte cost of one ``src → dst`` message."""
        if src == dst:
            return 0.0
        if self.is_cross_slice(src, dst):
            return self.dcn_cost
        return self.ici_cost * self.torus_hops(src, dst, world)

    def to_dict(self) -> dict:
        return {"slice_size": self.slice_size, "ici_cost": self.ici_cost,
                "dcn_cost": self.dcn_cost,
                "torus": list(self.torus) if self.torus else None}

    @classmethod
    def from_dict(cls, d: dict) -> "InterconnectModel":
        """Rebuild from :meth:`to_dict` output (plan/checkpoint meta)."""
        return cls(slice_size=d.get("slice_size"),
                   ici_cost=d.get("ici_cost") or DEFAULT_ICI_COST,
                   dcn_cost=d.get("dcn_cost") or DEFAULT_DCN_COST,
                   torus=tuple(d["torus"]) if d.get("torus") else None)


# the original pricing: one torus, every hop equal — rankings computed
# under this model match the pre-interconnect ring-hop scorer exactly
UNIFORM = InterconnectModel(slice_size=None, ici_cost=1.0, dcn_cost=1.0)


def make_interconnect(slice_size: int | None = None,
                      dcn_cost: float | None = None,
                      ici_cost: float | None = None,
                      torus: tuple[int, ...] | None = None
                      ) -> InterconnectModel | None:
    """CLI-flag resolver: None when no fabric structure was requested
    (the scorer then prices on :data:`UNIFORM`), else a model with the
    defaults filled in."""
    if slice_size is None and dcn_cost is None and ici_cost is None \
            and torus is None:
        return None
    if dcn_cost is not None and slice_size is None:
        raise ValueError(
            "dcn_cost prices inter-slice (DCN) crossings, which only "
            "exist when slice_size defines the slices — on an unsliced "
            "fabric the flag would silently never apply")
    return InterconnectModel(
        slice_size=slice_size,
        ici_cost=DEFAULT_ICI_COST if ici_cost is None else float(ici_cost),
        dcn_cost=DEFAULT_DCN_COST if dcn_cost is None else float(dcn_cost),
        torus=torus)
