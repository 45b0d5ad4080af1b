"""Language-model data: file corpora, the synthetic Markov corpus and
their batching.

A copy of ``load_corpus``, ``synthetic_lm_corpus`` and ``lm_batches``
from ``stochastic_gradient_push_tpu/data/lm.py`` (numpy only): the same
file or seed gives the same tokens, batch for batch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_corpus", "synthetic_lm_corpus", "markov_table",
           "markov_walk", "lm_batches"]


def load_corpus(path: str, vocab_size: int) -> np.ndarray:
    """A file corpus as int32 token ids.

    ``.npy``/``.npz`` files are pre-tokenized integer arrays (one array
    in an ``.npz``), checked against ``vocab_size``; any other file is
    read as raw bytes, a byte-level corpus (``vocab_size >= 256``).
    """
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):  # npz: single array expected
            names = list(arr.files)
            if len(names) != 1:
                raise ValueError(f"{path}: expected one array, "
                                 f"found {names}")
            arr = arr[names[0]]
        arr = np.asarray(arr).reshape(-1)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"{path}: token array must be integer, "
                             f"got {arr.dtype}")
        arr = arr.astype(np.int32)
        if arr.size and (arr.min() < 0 or arr.max() >= vocab_size):
            raise ValueError(
                f"{path}: token ids span [{arr.min()}, {arr.max()}] — "
                f"outside vocab_size {vocab_size}")
        return arr
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    if vocab_size < 256:
        raise ValueError(
            f"byte-level corpus needs vocab_size >= 256, got {vocab_size}")
    return data.astype(np.int32)


def synthetic_lm_corpus(n_tokens: int, vocab_size: int = 256,
                        order: int = 2, seed: int = 0) -> np.ndarray:
    """A learnable Markov corpus: each token depends on the previous
    ``order`` tokens through a fixed random table, so a causal LM can drive
    the loss well below the unigram entropy."""
    table, g = markov_table(vocab_size, order, seed)
    return markov_walk(table, g, n_tokens, vocab_size, order)


def markov_table(vocab_size: int, order: int = 2, seed: int = 0):
    """``(table, generator)``: the corpus's ``vocab^order`` transition
    table drawn from ``seed``, and the generator just after that draw,
    where :func:`markov_walk` continues the stream."""
    g = np.random.default_rng(seed)
    table = g.integers(0, vocab_size,
                       size=(vocab_size,) * order).astype(np.int32)
    return table, g


def markov_walk(table: np.ndarray, g: np.random.Generator, n_tokens: int,
                vocab_size: int, order: int = 2) -> np.ndarray:
    """``n_tokens`` of the walk over ``table``, drawing its noise and
    restarts from ``g``."""
    noise = g.random(n_tokens)
    toks = np.empty(n_tokens, np.int32)
    toks[:order] = g.integers(0, vocab_size, size=order)
    for i in range(order, n_tokens):
        if noise[i] < 0.9:  # mostly deterministic, some noise
            toks[i] = table[tuple(toks[i - order:i])]
        else:
            toks[i] = g.integers(0, vocab_size)
    return toks


def lm_batches(corpus: np.ndarray, dp: int, sp: int, batch: int,
               seq_len: int, seed: int = 0):
    """Yield ``(tokens, targets)`` of shape ``[dp, sp, batch, seq_len/sp]``.

    Each (dp, batch) sequence is contiguous; its target is the sequence
    shifted by one token (computed globally *before* sharding, so sequence
    shards need no cross-shard shift).  The sp dimension holds contiguous
    blocks of each sequence, matching ring attention's block layout.
    """
    if seq_len % sp:
        raise ValueError(f"seq_len {seq_len} not divisible by sp {sp}")
    block = seq_len // sp
    span = seq_len + 1
    n_seqs = (len(corpus) - 1) // seq_len
    if n_seqs < dp * batch:
        raise ValueError("corpus too small for one batch")
    g = np.random.default_rng(seed)
    starts_all = np.arange(n_seqs) * seq_len
    g.shuffle(starts_all)
    for i in range(0, len(starts_all) - dp * batch + 1, dp * batch):
        starts = starts_all[i:i + dp * batch]
        seqs = np.stack([corpus[s:s + span] for s in starts])  # [dp*b, L+1]
        tokens = seqs[:, :-1].reshape(dp, batch, sp, block)
        targets = seqs[:, 1:].reshape(dp, batch, sp, block)
        # [dp, batch, sp, block] → [dp, sp, batch, block]
        yield (np.ascontiguousarray(tokens.transpose(0, 2, 1, 3)),
               np.ascontiguousarray(targets.transpose(0, 2, 1, 3)))
