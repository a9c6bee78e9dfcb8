"""Token data pipeline — a copy of `repro/data/pipeline.py` (numpy only; the
port imports nothing of `repro`).

Production-shaped but self-contained (no external datasets are read;
all data is generated or written locally):

  * `SyntheticLM` — deterministic PRNG stream with learnable structure
    (repeated motifs + copy patterns) so small models visibly learn; used by
    the examples and the loss-curve benchmarks.
  * `MemmapDataset` — flat binary token file (np.memmap), the standard
    pretraining layout; `write_token_file` creates one.
  * `make_batch_iterator` — per-host sharding (each host reads only its
    slice: `host_id/host_count`), deterministic seeking by step for exact
    restart (fault tolerance: the iterator state is just `step`), and a
    background prefetch thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "MemmapDataset", "make_batch_iterator",
           "write_token_file"]


class SyntheticLM:
    """Deterministic synthetic LM stream with motif structure.

    Sequences mix (a) zipfian unigrams, (b) short repeated motifs, and
    (c) explicit copy segments (position t repeats position t-gap), giving
    both local and long-range learnable signal.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 n_motifs: int = 64, motif_len: int = 8):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab_size,
                                   size=(n_motifs, motif_len))

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        n, v = self.seq_len, self.vocab_size
        # zipf-ish unigrams
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(batch_size, n + 1), p=probs)
        # motif insertion
        for b in range(batch_size):
            for _ in range(max(1, n // 64)):
                m = self.motifs[rng.integers(len(self.motifs))]
                pos = rng.integers(0, n + 1 - len(m))
                toks[b, pos:pos + len(m)] = m
        # copy pattern in the second half
        gap = max(1, n // 4)
        half = (n + 1) // 2
        toks[:, half + gap:] = toks[:, half:-gap]
        tokens = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "targets": targets}


class MemmapDataset:
    """Flat binary int32 token file; standard pretraining layout."""

    def __init__(self, path: str, seq_len: int):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.n_seqs = (len(self.data) - 1) // seq_len

    def batch(self, step: int, batch_size: int, *, host_id: int = 0,
              host_count: int = 1) -> dict:
        n = self.seq_len
        per_host = batch_size // host_count
        idx0 = (step * batch_size + host_id * per_host) % max(
            1, self.n_seqs - per_host)
        rows = [(idx0 + i) % self.n_seqs for i in range(per_host)]
        tokens = np.stack([self.data[r * n:(r + 1) * n] for r in rows])
        targets = np.stack([self.data[r * n + 1:(r + 1) * n + 1]
                            for r in rows])
        return {"tokens": tokens.astype(np.int32),
                "targets": targets.astype(np.int32)}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, dtype=np.int32).tofile(path)


def make_batch_iterator(source, batch_size: int, *, start_step: int = 0,
                        host_id: int = 0, host_count: int = 1,
                        prefetch: int = 2) -> Iterator[dict]:
    """Background-prefetched, restartable iterator. Deterministic in `step`
    — restart after preemption by passing the checkpointed step."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            kw = {}
            if isinstance(source, MemmapDataset):
                kw = {"host_id": host_id, "host_count": host_count}
            try:
                q.put((step, source.batch(step, batch_size, **kw)),
                      timeout=1.0)
            except queue.Full:
                continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _It()
