"""Incremental ``events.jsonl`` tailer (a copy of
``stochastic_gradient_push_tpu/supervise/tailer.py``).

The supervisor reads the child's typed event stream while the child is
writing it, so the reader must survive everything a live JSONL file can
do to it:

* **partial trailing line** — ``JsonlSink`` writes line + flush, but the
  OS can expose a write mid-line; incomplete tails are buffered until
  the newline arrives, never parsed;
* **truncation / rotation** — a relaunched run may recreate the file, or
  an operator may rotate it; a shrinking size or a changed inode resets
  the read position to the start of the new file;
* **malformed lines** — skipped and counted, never raised: one corrupt
  line (torn write at a crash) must not blind the supervisor to every
  event after it;
* **unknown kinds** — passed through verbatim; the registry's vocabulary
  grows over time and an old supervisor must keep working against a
  newer child (the policy ignores kinds it doesn't know).
"""

from __future__ import annotations

import json
import os

__all__ = ["EventTailer"]


class EventTailer:
    """Poll-based reader yielding newly completed events since last poll."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._ino: int | None = None
        self._buf = ""
        self.skipped = 0          # malformed (non-JSON) complete lines
        self.events_seen = 0

    def poll(self) -> list[dict]:
        """Return events appended since the previous call (possibly [])."""
        try:
            st = os.stat(self.path)
        except OSError:
            return []  # not created yet (the child hasn't emitted)
        if self._ino is not None and st.st_ino != self._ino:
            # rotation: a new file took the name; start it from byte 0
            self._pos, self._buf = 0, ""
        elif st.st_size < self._pos:
            # truncation in place
            self._pos, self._buf = 0, ""
        self._ino = st.st_ino
        if st.st_size == self._pos:
            return []
        with open(self.path, "r") as f:
            f.seek(self._pos)
            chunk = f.read()
            self._pos = f.tell()
        self._buf += chunk
        *complete, self._buf = self._buf.split("\n")
        out: list[dict] = []
        for line in complete:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                self.skipped += 1
                continue
            if isinstance(ev, dict):
                out.append(ev)
            else:
                self.skipped += 1
        self.events_seen += len(out)
        return out
