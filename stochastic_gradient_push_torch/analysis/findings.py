"""The verifier's finding record (the part of the reference's
``analysis/findings.py`` that the schedule checks produce)."""

from __future__ import annotations

import dataclasses

__all__ = ["Finding"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier finding: where, which rule (``SGPV10x``), and what."""

    file: str
    line: int
    rule: str
    message: str
