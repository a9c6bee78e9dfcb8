"""Prompt-prefix cache: decode-state snapshots keyed by token-prefix hash —
port of `repro/serve/prefix_cache.py`.

Because prefill is resumable (``lm_prefill(offset=...)`` seeds the fastmax
moment scan / writes KV rows at an offset), a snapshot of a slot's state
after ``m`` prompt tokens lets any later request whose prompt starts with
the same ``m`` tokens skip straight to ``offset=m``. Snapshots are taken at
chunk boundaries during prefill, so keys are always prefixes of length
``k * chunk``.

For fastmax backends a snapshot is the constant-size moment tuple (and
an SSM layer's its recurrent state, which a resumed prefill continues
from), so a generous byte budget holds MANY prefixes; for the softmax
baseline each snapshot carries full ``max_len`` KV rows — the same O(1)-vs-O(N)
asymmetry the engine's slot accounting reports.

Entries are LRU-evicted once the byte budget is exceeded. All state stays
on device; the cache only holds references + host metadata. The engine
hands it copies (`SlotManager.snapshot`), never views into its pool, which
later ticks update in place.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.attention.state import state_leaves

__all__ = ["PrefixCache", "prefix_key"]


def prefix_key(prompt: np.ndarray, m: int) -> str:
    """Stable key for the first `m` tokens of `prompt`."""
    pre = np.ascontiguousarray(np.asarray(prompt[:m], np.int32))
    return hashlib.sha1(pre.tobytes()).hexdigest()


def _state_bytes(state: Any) -> int:
    """Bytes of a snapshot's leaves (tensors or numpy arrays)."""
    return int(sum(leaf.nbytes for leaf in state_leaves(state)))


class PrefixCache:
    def __init__(self, byte_budget: int, *, chunk: int):
        self.byte_budget = int(byte_budget)
        self.chunk = int(chunk)
        self._entries: "OrderedDict[str, Tuple[int, Any, int]]" = \
            OrderedDict()  # key -> (m, state, nbytes)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> Tuple[int, Optional[Any]]:
        """Longest cached prefix of `prompt` STRICTLY shorter than the
        prompt (at least one token must go through prefill to produce the
        first logits). Returns (m, state) or (0, None)."""
        plen = len(prompt)
        top = (plen - 1) // self.chunk * self.chunk
        if top <= 0:
            # no cacheable prefix even exists at this length (keys are
            # multiples of chunk, strictly shorter than the prompt) — not a
            # miss, or sub-chunk prompts would skew the hit-rate stats
            return 0, None
        for m in range(top, 0, -self.chunk):
            key = prefix_key(prompt, m)
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return ent[0], ent[1]
        self.misses += 1
        return 0, None

    def insert(self, prompt: np.ndarray, m: int, state: Any) -> None:
        """Cache `state` as the snapshot after the first `m` tokens of
        `prompt` (m must sit on a chunk boundary)."""
        if self.byte_budget <= 0 or m <= 0 or m % self.chunk:
            return
        key = prefix_key(prompt, m)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        nbytes = _state_bytes(state)
        if nbytes > self.byte_budget:
            return
        self._entries[key] = (m, state, nbytes)
        self.bytes += nbytes
        self.insertions += 1
        while self.bytes > self.byte_budget:
            _, (_, _, nb) = self._entries.popitem(last=False)
            self.bytes -= nb
            self.evictions += 1

    def invalidate(self, prompt: np.ndarray) -> int:
        """Drop every cached snapshot keyed by a chunk-boundary prefix of
        `prompt`. Used when the request that produced the snapshots is
        cancelled (its device references should be released) or its slot is
        quarantined (snapshots taken from a poisoned slot must never seed
        another request). Returns the number of entries removed."""
        removed = 0
        for m in range(self.chunk, len(prompt) + 1, self.chunk):
            ent = self._entries.pop(prefix_key(prompt, m), None)
            if ent is not None:
                self.bytes -= ent[2]
                self.evictions += 1
                removed += 1
        return removed

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses,
                "insertions": self.insertions, "evictions": self.evictions}
