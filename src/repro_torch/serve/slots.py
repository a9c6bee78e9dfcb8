"""Slot-indexed batched decode state: a fixed pool of B sequence slots —
port of `repro/serve/slots.py`.

The continuous-batching engine keeps ONE model decode state allocated for
`max_slots` sequences and treats its batch axis as a pool of slots.
Admitting a request writes one slot's rows of every leaf, in place; the
pool is never reallocated as requests come and go.

  fastmax  -> a slot's state is the constant-size moment tuple (O(D^2 Dv)
              per kv head, whatever the context length): no paged-KV
              block tables.
  softmax  -> a slot's state is `max_len` masked KV-cache rows with a
              per-slot write cursor (`KVCache.length` as a [B] lane): the
              O(N) baseline.
  SSM      -> a Mamba layer's (conv inputs, h), an mLSTM layer's (C, n)
              and an sLSTM layer's (c, n, m, h): constant-size recurrent
              states, reset to their fresh fills (sLSTM's m to -1e9).

The slot axis of every leaf is found once per (config, pool) by building
the state on the `meta` device at batch 2 and 3 (the counterpart of the
reference's `jax.eval_shape`): the one axis whose extent changes is the
slot axis. In the port's layout it is axis 1 of every leaf of a stacked
`blocks_i` state ([n_groups, B, ...], a slotted length [n_groups, B]) and
axis 0 of a `dense_i` state ([B, ...], a slotted length [B]), the leading
dense blocks of an MoE model; the pool handles each leaf by its own
axis.

Unlike the reference, whose states are immutable values, the port's pool
is updated in place: `read_slot` returns views into the pool (the batch-1
state a prefill chunk writes through), and `snapshot` clones them, so a
prefix-cache entry does not change under later ticks.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.attention.state import AttnState, KVCache, map_state

__all__ = ["SlotManager", "to_slotted", "slot_batch_axes", "write_slot",
           "read_slot"]


def to_slotted(state: Any):
    """Give every `KVCache` in a fresh decode state a PER-SLOT cursor:
    `length` [n_groups] -> [n_groups, B] ([] -> [B] in a `dense_i` state;
    the softmax write cursor, the hybrid window's token count), so slots
    can sit at different context lengths inside one batched step."""
    def fix(node):
        if isinstance(node, KVCache):
            b = node.k.shape[node.length.dim()]
            return node._replace(length=torch.zeros(
                tuple(node.length.shape) + (b,), dtype=torch.int32,
                device=node.length.device))
        if isinstance(node, AttnState):
            return AttnState(kv=fix(node.kv), moments=node.moments)
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(state)


def slot_batch_axes(make_state):
    """Per-leaf slot axes (a tree of ints) for states built by
    `make_state(batch, device)`: built on the `meta` device at batch 2 and
    3, exactly one axis must differ per leaf. A leaf that does not depend
    on the batch would be shared across slots, so it raises."""
    def one_axis(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        if len(diffs) != 1:
            raise ValueError(
                f"decode-state leaf {tuple(a.shape)} has no unique slot "
                f"axis (vs {tuple(b.shape)}): a shared leaf cannot be "
                f"slot-pooled")
        return diffs[0]

    return map_state(one_axis, make_state(2, "meta"), make_state(3, "meta"))


def write_slot(pool_state, unit_state, slot: int, axes) -> None:
    """Write a batch-1 unit state into slot `slot` of the pool, in place."""
    map_state(lambda p, u, ax: p.narrow(ax, slot, 1).copy_(u), pool_state,
              unit_state, axes)


def read_slot(pool_state, slot: int, axes):
    """Slot `slot` as a batch-1 unit state of VIEWS into the pool: what is
    written through it lands in the pool (clone it to keep a copy). Each
    layer's view (a `dense_i` leaf, or `leaf[g]` of a stacked one) is
    contiguous."""
    return map_state(lambda p, ax: p.narrow(ax, slot, 1), pool_state, axes)


def _fill_value(leaf: torch.Tensor):
    """The one value of a leaf of a freshly built state (each leaf is
    constant there; checked, since `reset` relies on it)."""
    lo, hi = (t.item() for t in torch.aminmax(leaf))
    if lo != hi:
        raise ValueError(f"a fresh decode-state leaf {tuple(leaf.shape)} is "
                         f"not constant: a slot cannot be reset by a fill")
    return lo


class SlotManager:
    """Owns the pooled decode state and the per-slot lanes.

    The state stays on the device between ticks; the small int/bool lanes
    live on the host (numpy), because the engine reads and branches on them
    every tick anyway (admission, eviction, streaming).
    """

    def __init__(self, cfg, max_slots: int, max_len: int, *, device=None):
        from repro_torch.models import init_decode_state

        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self._make = lambda b, dev: to_slotted(
            init_decode_state(cfg, b, max_len, device=dev))
        self.axes = slot_batch_axes(self._make)
        self.state = self._make(max_slots, device)
        # a fresh state is one constant per leaf (zeros; ones in the
        # softmax cache's mask lane): a cold admit fills the slot's rows
        # with it in place, so no fresh template is kept on the device
        self.fills = map_state(_fill_value, self.state)
        self.position = np.zeros(max_slots, np.int32)
        self.active = np.zeros(max_slots, bool)
        self.eos = np.zeros(max_slots, bool)

    # -- admit / evict -------------------------------------------------------

    def admit(self, slot: int, unit_state=None, position: int = 0):
        """Install a unit state (fresh, or a prefix-cache snapshot covering
        `position` tokens) into `slot`."""
        if unit_state is None:
            self.reset(slot)
        else:
            write_slot(self.state, unit_state, slot, self.axes)
        self.position[slot] = position
        self.active[slot] = False
        self.eos[slot] = False

    def evict(self, slot: int):
        """Free a slot. The state is NOT cleared: the next admit rewrites
        every leaf of the slot, so eviction is host bookkeeping only."""
        self.active[slot] = False
        self.eos[slot] = False
        self.position[slot] = 0

    def quarantine(self, slot: int):
        """Free a slot AND re-initialize its state, so a poisoned slot
        (NaN/Inf leaves) does not sit in the pool where the deep state
        check would see it. The slot is reusable at once."""
        self.reset(slot)
        self.evict(slot)

    def reset(self, slot: int):
        """Fill every leaf's rows of `slot` with its fresh value, in
        place."""
        map_state(lambda p, ax, f: p.narrow(ax, slot, 1).fill_(f),
                  self.state, self.axes, self.fills)

    def view(self, slot: int):
        """Slot `slot` as a batch-1 state of views into the pool."""
        return read_slot(self.state, slot, self.axes)

    def snapshot(self, slot: int):
        """Batch-1 COPY of a slot's state (a prefix-cache entry)."""
        return map_state(torch.clone, self.view(slot))

    def save(self, slots) -> dict:
        """{slot: copy of its state} for slots that must come out of an
        in-place batched step unchanged (written back by `restore`)."""
        return {s: self.snapshot(s) for s in slots}

    def restore(self, saved: dict):
        """Write the copies taken by `save` back into their slots."""
        for s, unit in saved.items():
            write_slot(self.state, unit, s, self.axes)

    def state_bytes_per_slot(self) -> int:
        """Slot cost in bytes: constant in context for fastmax, linear for
        the softmax KV baseline (`core.decode_state.decode_state_bytes`)."""
        from repro_torch.core.decode_state import decode_state_bytes
        return decode_state_bytes(self.cfg, 1, self.max_len)
