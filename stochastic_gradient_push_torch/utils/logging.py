"""Rank-prefixed stdout logger.

A copy of ``make_logger`` and ``reset_logger`` from
``stochastic_gradient_push_tpu/utils/logging.py``: one logger per rank
name, the rank prefix and the ``%(threadName)s`` field in the format, so
log-parsing tooling sees the reference's line shape.  One change: the
handler writes to whatever ``sys.stdout`` is when a line is logged, so a
caller that swaps stdout (a test's capture) gets the lines; the
reference's handler keeps the stream of its first use.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["make_logger", "reset_logger"]


class _StdoutHandler(logging.StreamHandler):
    """A stream handler bound to the current ``sys.stdout``."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def make_logger(rank: int | str, verbose: bool = True) -> logging.Logger:
    # one logger per rank: one process can hold many ranks, so the rank
    # prefix must not be latched by first use
    logger = logging.getLogger(f"{__name__}.rank{rank}")
    if not getattr(logger, "handler_set", None):
        console = _StdoutHandler()
        console.setFormatter(logging.Formatter(
            f"{rank}: %(levelname)s -- %(threadName)s -- %(message)s"))
        logger.addHandler(console)
        logger.propagate = False
        logger.handler_set = True
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger


def reset_logger(rank: int | str) -> logging.Logger:
    """Drop the rank logger's handler; the next :func:`make_logger`
    installs a fresh one."""
    logger = logging.getLogger(f"{__name__}.rank{rank}")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.handler_set = None
    return logger
