"""Continuous-batching serving engine over the decode-state protocol —
port of `repro/serve/engine.py`.

One `ServeEngine` owns a `SlotManager` pool of `max_slots` sequences and
advances the whole pool one "tick" at a time. A tick has two parts, run
eagerly (no graph capture):

  prefill part  -> the next `chunk`-token slice of ONE pending request's
                   prompt runs through `lm_prefill(offset=...)` on that
                   slot's state, a batch-1 view into the pool that the
                   prefill writes through. A ragged last chunk runs at
                   its own length: the reference pads it to `chunk` and
                   masks it, so that its jit traces one shape, which an
                   eager port does not need (and a padded softmax chunk
                   would write past the cache's last row).
                   The chunk that completes the prompt also emits the
                   request's FIRST token (argmax of its last valid row).
  decode part   -> every slot takes one batched `lm_decode_step` with its
                   own last token and position.

All backends run the same `init_state`/`prefill`/`step` protocol, so the
engine serves the softmax KV cache, fastmax (chunked or kernel) and the
hybrid family alike, and the SSM mixers (jamba's Mamba layers, xlstm's
mLSTM and sLSTM) resume a prefill chunk from their recurrent state, which
needs the exact-length ragged chunk (they refuse a `kv_mask`); greedy
decoding gives `launch.serve.generate`'s tokens request by request
(`tests/test_torch_serve.py`, `tests/test_torch_ssm_archs.py`). On
fastmax-kernel with CUDA weights every prefill chunk runs the prefill
kernel seeded with the slot's carry and every decode part the decode
kernel, one launch per layer each; CPU weights take the kernels' plain
versions, and nothing else is ever rerouted.

The decode part and the in-place state. The reference's tick is a pure
function: the batched step runs over every slot and `select_slots` keeps
the old state of each slot that is not decoding. The port's state is
updated in place (the decode kernel folds a token into every slot's
carry), so the engine instead copies, before the decode part, the rows of
every leaf of each OCCUPIED slot that is not decoding (a request mid-
prefill, or admitted and not yet prefilled) and writes them back after:
such a slot comes out of the tick bit for bit as it went in
(`SlotManager.save`/`restore`). That reads and writes the slot's whole
state twice per tick (a qwen3-1.7b fastmax slot holds about 1.9 GB). A
free slot takes the step unrestored (its next admit rewrites every leaf),
and when every occupied slot is decoding nothing is copied.

Host traffic is per tick, not per layer: the decode part's tokens and
positions and the prefill chunk's tokens go to the device in one copy
(from pinned memory on a card), and the tick reads back once: the first
token, the next tokens and the finite-logits flags. `prefill_row` keeps
the last prefill chunk's last logit row on the device.

The robustness layer is the reference's, unchanged (`serve/errors.py`):
statuses and `FinishedRequest` records for every terminal outcome, a
bounded queue with `EngineOverloaded` and load shedding, TTFT and total
deadlines, `cancel(rid)`, a per-tick non-finite guard on the emitted
logits that fails only the poisoned request and quarantines its slot
(`REPRO_SERVE_CHECK_STATE=1` adds a deep check of every floating state
leaf), a watchdog raising `EngineStalled` with a snapshot, and `stats()`
counters. Deterministic chaos lives in `serve/faults.py`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.ft import StragglerMonitor
from repro_torch.models.transformer import (ModelConfig, lm_decode_step,
                                            lm_prefill)
from repro_torch.serve.errors import (TERMINAL_STATUSES, EngineOverloaded,
                                      EngineStalled, RequestStatus)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.attention.state import state_leaves
from repro_torch.serve.slots import SlotManager

__all__ = ["ServeEngine", "FinishedRequest"]

# status -> stats() counter bumped when a request reaches that terminal
_TERMINAL_COUNTER = {
    RequestStatus.FINISHED: "finished",
    RequestStatus.FAILED: "failed",
    RequestStatus.CANCELLED: "cancelled",
    RequestStatus.TIMED_OUT: "timed_out",
    RequestStatus.REJECTED: "shed",
}


def _check_eos_id(eos) -> Optional[int]:
    """eos_id must be a non-negative integer token id (bool is an int
    subclass and always a bug here, so it is rejected explicitly)."""
    if eos is None:
        return None
    if isinstance(eos, bool) or not isinstance(eos, (int, np.integer)):
        raise ValueError(
            f"eos_id must be an integer token id, got "
            f"{type(eos).__name__}: {eos!r}")
    if eos < 0:
        raise ValueError(f"eos_id must be non-negative, got {eos}")
    return int(eos)


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray            # [n_generated] int32 (includes eos if hit)
    prompt_len: int
    ttft: Optional[float]         # submit -> first token (s); None if never
    latency: float                # submit -> terminal state (s)
    status: RequestStatus = RequestStatus.FINISHED
    error: Optional[str] = None   # diagnostic on non-FINISHED terminals

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 policy: str = "fcfs", chunk: Optional[int] = None,
                 prefix_cache_bytes: int = 0, max_wait: int = 64,
                 max_queue: int = 256, max_queue_tokens: int = 0,
                 shed_after: int = 64, tick_budget_s: Optional[float] = None,
                 stall_ticks: int = 64, faults=None):
        if cfg.encoder_layers > 0:
            raise NotImplementedError(
                "the serving engine targets decoder-only models; use "
                "launch.serve.generate for encoder-decoder")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.eos_id = _check_eos_id(eos_id)
        self.chunk = int(chunk or cfg.chunk_size)
        self.slots = SlotManager(cfg, max_slots, max_len, device=self.device)
        self.scheduler = Scheduler(policy, max_wait=max_wait,
                                   max_depth=max_queue,
                                   max_queued_tokens=max_queue_tokens)
        self.prefix_cache = (PrefixCache(prefix_cache_bytes, chunk=self.chunk)
                             if prefix_cache_bytes > 0 else None)

        b = self.slots.max_slots
        self._rid: List[Optional[int]] = [None] * b
        self._req: Dict[int, Request] = {}
        self._prompt_len = np.zeros(b, np.int32)
        self._last_token = np.zeros(b, np.int32)
        self._generated: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._prefill_cursor = 0      # round-robin over mid-prefill slots
        self.tick_count = 0
        self.prefill_ticks = 0        # ticks with a prefill part
        self.decode_ticks = 0         # ticks with a decode part
        self.restored_slots = 0       # slot states saved and written back
        self.decode_tokens = 0        # decode-part tokens (TPOT accounting)
        self.prefill_tokens = 0
        self.prefill_row = None       # last prefill chunk's last valid row
        self.history: List[FinishedRequest] = []   # load-gen latency stats
        self.statuses: Dict[int, RequestStatus] = {}  # rid -> last status
        # one host buffer per tick: decode tokens [B], positions [B], then
        # the prefill chunk's tokens [chunk]; pinned on a card so that its
        # copy does not wait for the device to drain
        self._host = torch.zeros(2 * b + self.chunk, dtype=torch.int64,
                                 pin_memory=self.device.type == "cuda")

        # robustness knobs
        self.shed_after = int(shed_after)     # saturated ticks before shed
        self.tick_budget_s = tick_budget_s    # wall-clock budget per tick
        self.stall_ticks = int(stall_ticks)   # no-progress ticks -> stalled
        self.faults = faults                  # serve.faults.FaultInjector
        self.monitor = StragglerMonitor()     # tick-time stats (ft idiom)
        self.counters: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "shed": 0, "timed_out": 0,
            "cancelled": 0, "quarantined": 0, "failed": 0, "finished": 0}
        self._saturated_ticks = 0
        self._stall_strikes = 0
        self._budget_strikes = 0
        self._budget_patience = 3
        self._check_state = os.environ.get("REPRO_SERVE_CHECK_STATE") == "1"

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               callback=None, ttft_deadline: Optional[float] = None,
               deadline: Optional[float] = None) -> int:
        """Enqueue one request. Raises `ValueError` on malformed input and
        `EngineOverloaded` when the bounded queue refuses admission (the
        engine state is unchanged in both cases)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError(
                "empty prompt: at least one token must prefill to produce "
                "the first logits")
        if len(prompt) > self.slots.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the model context "
                f"(engine max_len {self.slots.max_len})")
        if max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.slots.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + gen {max_new_tokens} exceeds "
                f"max_len {self.slots.max_len}")
        eos = self.eos_id if eos_id is None else _check_eos_id(eos_id)
        for name, d in (("ttft_deadline", ttft_deadline),
                        ("deadline", deadline)):
            if d is not None and d < 0:
                raise ValueError(f"{name} must be >= 0 seconds, got {d}")
        req = Request(
            rid=self._next_rid, prompt=prompt,
            max_new_tokens=int(max_new_tokens), eos_id=eos,
            callback=callback, submit_tick=self.tick_count,
            submit_time=time.monotonic(),
            ttft_deadline=ttft_deadline, deadline=deadline)
        try:
            self.scheduler.push(req)
        except EngineOverloaded:
            self.counters["rejected"] += 1
            raise
        self._next_rid += 1
        self.statuses[req.rid] = RequestStatus.QUEUED
        return req.rid

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in a slot)."""
        return len(self.scheduler) + sum(r is not None for r in self._rid)

    def status(self, rid: int) -> Optional[RequestStatus]:
        """Last known status of a request (None for unknown rids)."""
        return self.statuses.get(rid)

    def stats(self) -> Dict[str, int]:
        """Host-side health counters: terminal-outcome totals, the
        instantaneous queue / slot occupancy, the ticks with a prefill and
        with a decode part, and the slot states restored around decode
        parts."""
        return {
            **self.counters,
            "queue_depth": len(self.scheduler),
            "queued_tokens": self.scheduler.queued_tokens,
            "slots_occupied": sum(r is not None for r in self._rid),
            "slots_total": self.slots.max_slots,
            "ticks": self.tick_count,
            "prefill_ticks": self.prefill_ticks,
            "decode_ticks": self.decode_ticks,
            "restored_slots": self.restored_slots,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
        }

    def snapshot(self) -> Dict[str, Any]:
        """Postmortem view of the engine (attached to `EngineStalled`)."""
        return {
            "tick": self.tick_count,
            "queue_depth": len(self.scheduler),
            "queued_tokens": self.scheduler.queued_tokens,
            "slots": [
                {"slot": i, "rid": self._rid[i],
                 "position": int(self.slots.position[i]),
                 "prompt_len": int(self._prompt_len[i]),
                 "active": bool(self.slots.active[i]),
                 "eos": bool(self.slots.eos[i])}
                for i in range(self.slots.max_slots)],
            "counters": dict(self.counters),
            "tick_time": self.monitor.stats(),
        }

    # -- cancellation --------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is — queued, mid-prefill, or
        mid-decode. Frees its slot immediately, drops its prefix-cache
        snapshots, and records a CANCELLED `FinishedRequest` (with the
        tokens generated so far) in `history`. Returns False for unknown
        or already-terminal rids."""
        req = self.scheduler.remove(rid)
        if req is not None:
            self._finalize(req, [], RequestStatus.CANCELLED,
                           "cancelled while queued", [])
            return True
        for slot in range(self.slots.max_slots):
            if self._rid[slot] == rid:
                req = self._req[rid]
                phase = "decode" if self.slots.active[slot] else "prefill"
                toks = self._generated.pop(rid, [])
                if self.prefix_cache is not None:
                    self.prefix_cache.invalidate(req.prompt)
                self._rid[slot] = None
                del self._req[rid]
                self.slots.evict(slot)
                self._finalize(req, toks, RequestStatus.CANCELLED,
                               f"cancelled mid-{phase}", [])
                return True
        return False

    # -- the tick ------------------------------------------------------------

    def step(self) -> List[FinishedRequest]:
        """Advance the pool by one tick (a prefill part, a decode part, or
        both). Returns every request that reached a terminal state this
        tick (finished, failed, timed out, or shed)."""
        self.monitor.start_step()
        self.tick_count += 1
        if self.faults is not None:
            self.faults.apply(self, self.tick_count)
        finished: List[FinishedRequest] = []
        self._expire_deadlines(finished)
        self._shed_if_saturated(finished)
        admitted = self._admit()

        pre = self._pick_prefill()
        live = self.slots.active & ~self.slots.eos
        do_decode = bool(live.any())
        if pre is not None or do_decode:
            first_tok, pre_ok, nxt, dec_ok = self._tick(pre, live)
            if pre is not None:
                self.prefill_ticks += 1
                self._after_prefill(pre[0], pre[3], first_tok, pre_ok,
                                    finished)
            if do_decode:
                self.decode_ticks += 1
                self._after_decode(live, nxt, dec_ok, finished)
            if self._check_state:
                self._deep_state_check(finished)

        progressed = bool(admitted or pre is not None or do_decode
                          or finished)
        self._watchdog(self.monitor.end_step(), progressed)
        return finished

    def _tick(self, pre, live):
        """Run the tick's parts on the device (see the module docstring):
        one host-to-device copy in, one read-back out. Returns (first
        token, prefill logits finite, next tokens [B], decode logits
        finite [B]), None for a part that did not run."""
        b, dev = self.slots.max_slots, self.device
        do_decode = bool(live.any())
        host = self._host.numpy()
        if do_decode:
            host[:b] = self._last_token
            host[b:2 * b] = self.slots.position
        if pre is not None:
            slot, toks, off, n = pre
            host[2 * b:2 * b + n] = toks
        up = self._host[:2 * b + (n if pre is not None else 0)].to(
            dev, non_blocking=True)
        flags = []
        with torch.inference_mode():
            if pre is not None:
                logits, _ = lm_prefill(self.params, up[2 * b:][None],
                                       self.cfg, self.slots.view(slot),
                                       offset=off)
                self.prefill_row = row = logits[0, -1]
                flags += [row.argmax().view(1), torch.isfinite(row).all()
                          .view(1)]
            if do_decode:
                keep = [s for s in range(b)
                        if self._rid[s] is not None and not live[s]]
                saved = self.slots.save(keep)
                self.restored_slots += len(saved)
                logits, _ = lm_decode_step(self.params, self.slots.state,
                                           up[:b], self.cfg,
                                           position=up[b:2 * b])
                self.slots.restore(saved)
                flags += [logits.argmax(dim=-1),
                          torch.isfinite(logits).all(dim=-1)]
            out = torch.cat([f.to(torch.int64) for f in flags]).cpu().numpy()
        first_tok = pre_ok = nxt = dec_ok = None
        if pre is not None:
            first_tok, pre_ok, out = int(out[0]), bool(out[1]), out[2:]
        if do_decode:
            nxt, dec_ok = out[:b], out[b:].astype(bool)
        return first_tok, pre_ok, nxt, dec_ok

    def run(self, *, max_ticks: int = 1_000_000) -> Dict[int, np.ndarray]:
        """Drive ticks until every submitted request reached a terminal
        state. Returns {rid: tokens} for every request that terminated
        inside the loop (failed/timed-out entries carry the tokens
        generated before the fault). Raises `EngineStalled` — with an
        engine snapshot — if `max_ticks` is exhausted with requests still
        pending, instead of silently returning a partial map."""
        done: Dict[int, np.ndarray] = {}
        for _ in range(max_ticks):
            if not self.pending:
                return done
            for fin in self.step():
                done[fin.rid] = fin.tokens
        if self.pending:
            raise EngineStalled(
                f"run() exhausted max_ticks={max_ticks} with {self.pending} "
                f"requests still pending "
                f"({len(self.scheduler)} of them queued)", self.snapshot())
        return done

    def stream(self, prompt, max_new_tokens: int, *,
               eos_id=None) -> Iterator[int]:
        """Submit one request and yield its tokens as they are produced
        (other already-submitted requests keep making progress). Stops
        cleanly if the request reaches ANY terminal state — a cancelled or
        failed stream simply ends after its last good token."""
        box: List[int] = []
        rid = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                          callback=lambda _rid, tok: box.append(tok))
        while True:
            fins = self.step()
            while box:
                yield box.pop(0)
            if any(f.rid == rid for f in fins):
                return
            if self.statuses.get(rid) in TERMINAL_STATUSES:
                return              # cancelled/failed outside this tick

    # -- internals -----------------------------------------------------------

    def _finalize(self, req: Request, tokens, status: RequestStatus,
                  error: Optional[str],
                  finished: List[FinishedRequest]) -> FinishedRequest:
        """Single exit point for every terminal outcome: stamp the request,
        bump the status counter, and record the FinishedRequest."""
        req.finish_time = time.monotonic()
        req.status = status
        req.error = error
        fin = FinishedRequest(
            rid=req.rid,
            tokens=np.asarray(tokens, np.int32),
            prompt_len=len(req.prompt),
            ttft=(None if req.first_token_time is None
                  else req.first_token_time - req.submit_time),
            latency=req.finish_time - req.submit_time,
            status=status, error=error)
        self.statuses[req.rid] = status
        self.counters[_TERMINAL_COUNTER[status]] += 1
        self.history.append(fin)
        finished.append(fin)
        return fin

    def _expire_deadlines(self, finished: List[FinishedRequest]) -> None:
        now = time.monotonic()
        for req in self.scheduler.take_expired(now):
            self._finalize(
                req, [], RequestStatus.TIMED_OUT,
                f"RequestTimeout: deadline expired after "
                f"{now - req.submit_time:.3f}s in queue", finished)
        for slot in range(self.slots.max_slots):
            rid = self._rid[slot]
            if rid is None:
                continue
            req = self._req[rid]
            waited = now - req.submit_time
            if req.first_token_time is None and \
                    req.ttft_deadline is not None and \
                    waited > req.ttft_deadline:
                self._release_abnormal(
                    slot, RequestStatus.TIMED_OUT,
                    f"RequestTimeout: TTFT deadline {req.ttft_deadline}s "
                    f"expired after {waited:.3f}s (prefill at "
                    f"{int(self.slots.position[slot])}/"
                    f"{int(self._prompt_len[slot])})", finished)
            elif req.deadline is not None and waited > req.deadline:
                self._release_abnormal(
                    slot, RequestStatus.TIMED_OUT,
                    f"RequestTimeout: deadline {req.deadline}s expired "
                    f"after {waited:.3f}s", finished)

    def _shed_if_saturated(self, finished: List[FinishedRequest]) -> None:
        """Graceful degradation: once the bounded queue has been FULL for
        `shed_after` consecutive ticks, shed the newest/largest waiters
        down to 3/4 depth — predictable victims with a clear status instead
        of unbounded waiting for everyone."""
        depth_cap = self.scheduler.max_depth
        if not self.shed_after or not depth_cap:
            return
        if len(self.scheduler) >= depth_cap:
            self._saturated_ticks += 1
        else:
            self._saturated_ticks = 0
            return
        if self._saturated_ticks < self.shed_after:
            return
        target = max(1, (3 * depth_cap) // 4)
        while len(self.scheduler) > target:
            req = self.scheduler.shed()
            if req is None:
                break
            self._finalize(
                req, [], RequestStatus.REJECTED,
                f"shed after {self._saturated_ticks} ticks of sustained "
                f"queue saturation (depth {depth_cap})", finished)
        self._saturated_ticks = 0            # re-arm

    def _watchdog(self, dt: float, progressed: bool) -> None:
        """Stall detection: sustained blown tick budgets or sustained
        no-progress ticks (with requests pending) raise `EngineStalled`
        carrying `snapshot()` — the engine never silently spins."""
        if self.tick_budget_s is not None and dt > self.tick_budget_s:
            self._budget_strikes += 1
            if self._budget_strikes >= self._budget_patience:
                raise EngineStalled(
                    f"tick wall-clock budget blown "
                    f"{self._budget_strikes}x in a row (last tick "
                    f"{dt * 1e3:.1f}ms > budget "
                    f"{self.tick_budget_s * 1e3:.1f}ms)", self.snapshot())
        else:
            self._budget_strikes = 0
        if self.pending and not progressed:
            self._stall_strikes += 1
            if self._stall_strikes >= self.stall_ticks:
                raise EngineStalled(
                    f"no tick progress for {self._stall_strikes} ticks "
                    f"with {self.pending} requests pending", self.snapshot())
        else:
            self._stall_strikes = 0

    def _admit(self) -> int:
        n = 0
        for slot in range(self.slots.max_slots):
            if self._rid[slot] is not None:
                continue
            req = self.scheduler.pop(self.tick_count)
            if req is None:
                return n
            offset, snap = (0, None)
            if self.prefix_cache is not None:
                offset, snap = self.prefix_cache.lookup(req.prompt)
            self.slots.admit(slot, unit_state=snap, position=offset)
            self._rid[slot] = req.rid
            self._req[req.rid] = req
            self._prompt_len[slot] = len(req.prompt)
            self._generated[req.rid] = []
            req.status = RequestStatus.PREFILL
            self.statuses[req.rid] = RequestStatus.PREFILL
            self.counters["admitted"] += 1
            n += 1
        return n

    def _pick_prefill(self):
        """Next slot still owing prompt tokens -> (slot, its next chunk's
        tokens, offset, number of tokens).

        Round-robin from a persistent cursor, NOT always the lowest slot:
        one tick prefills one chunk, so a lowest-first scan would feed
        slot 0's long prompt to completion while later slots (admitted the
        same tick) wait at position 0 — head-of-line bias that inflates
        their TTFT. The cursor resumes after the last-served slot so
        concurrent prompts interleave chunk-for-chunk. A chunk shorter
        than `chunk` (the prompt's last) runs at its own length."""
        b = self.slots.max_slots
        for i in range(b):
            slot = (self._prefill_cursor + i) % b
            rid = self._rid[slot]
            if rid is None or self.slots.active[slot] or self.slots.eos[slot]:
                continue
            pos = int(self.slots.position[slot])
            plen = int(self._prompt_len[slot])
            if pos >= plen:
                continue
            self._prefill_cursor = (slot + 1) % b
            n = min(self.chunk, plen - pos)
            return slot, self._req[rid].prompt[pos:pos + n], pos, n

    def _after_prefill(self, slot: int, nvalid: int, tok: int, ok: bool,
                       finished: List[FinishedRequest]) -> None:
        if not ok:
            self._quarantine_slot(
                slot, "SlotQuarantined: non-finite logits in prefill chunk "
                      f"(position {int(self.slots.position[slot])})",
                finished)
            return
        rid = self._rid[slot]
        req = self._req[rid]
        self.slots.position[slot] += nvalid
        self.prefill_tokens += int(nvalid)
        pos = int(self.slots.position[slot])
        plen = int(self._prompt_len[slot])
        if self.prefix_cache is not None and pos % self.chunk == 0:
            self.prefix_cache.insert(req.prompt, pos,
                                     self.slots.snapshot(slot))
        if pos < plen:
            return
        # prompt complete: the prefill logits' last valid row is token #1
        self.slots.active[slot] = True
        self._last_token[slot] = tok
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
        req.status = RequestStatus.DECODE
        self.statuses[rid] = RequestStatus.DECODE
        self._emit(slot, rid, tok, finished)

    def _after_decode(self, live: np.ndarray, nxt: np.ndarray,
                      ok: np.ndarray,
                      finished: List[FinishedRequest]) -> None:
        for slot in np.nonzero(live)[0]:
            slot = int(slot)
            rid = self._rid[slot]
            if rid is None:
                continue            # freed earlier this tick
            if not ok[slot]:
                self._quarantine_slot(
                    slot, "SlotQuarantined: non-finite logits in decode "
                          f"step (position {int(self.slots.position[slot])})",
                    finished)
                continue
            tok = int(nxt[slot])
            self.slots.position[slot] += 1
            self._last_token[slot] = tok
            self.decode_tokens += 1
            self._emit(slot, rid, tok, finished)

    def _quarantine_slot(self, slot: int, error: str,
                         finished: List[FinishedRequest]) -> None:
        """Fail ONLY the poisoned request: drop its prefix-cache snapshots
        (they may carry the same non-finite state), re-initialize the
        slot, and keep every other slot serving."""
        rid = self._rid[slot]
        req = self._req[rid]
        toks = self._generated.pop(rid, [])
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate(req.prompt)
        self._rid[slot] = None
        del self._req[rid]
        self.slots.quarantine(slot)
        self.counters["quarantined"] += 1
        self._finalize(req, toks, RequestStatus.FAILED, error, finished)

    def _release_abnormal(self, slot: int, status: RequestStatus,
                          error: str,
                          finished: List[FinishedRequest]) -> None:
        """Free a slot whose request terminated abnormally (deadline).
        Plain evict — the state is finite, just no longer wanted."""
        rid = self._rid[slot]
        req = self._req[rid]
        toks = self._generated.pop(rid, [])
        self._rid[slot] = None
        del self._req[rid]
        self.slots.evict(slot)
        self._finalize(req, toks, status, error, finished)

    def _deep_state_check(self, finished: List[FinishedRequest]) -> None:
        """REPRO_SERVE_CHECK_STATE=1: one reduction over every floating
        decode-state leaf per tick -> per-slot finite flags (one more
        read-back). Catches moment-lane overflow BEFORE it surfaces in
        logits (and before a poisoned snapshot can enter the prefix
        cache)."""
        ok = _finite_per_slot(self.slots.state, self.slots.axes,
                              self.slots.max_slots)
        for slot in np.nonzero(~ok)[0]:
            slot = int(slot)
            if self._rid[slot] is None:
                # free slot holding stale non-finite leaves: scrub quietly
                self.slots.quarantine(slot)
                continue
            self._quarantine_slot(
                slot, "SlotQuarantined: non-finite decode-state leaf "
                      "(REPRO_SERVE_CHECK_STATE deep check)", finished)

    def _emit(self, slot: int, rid: int, tok: int,
              finished: List[FinishedRequest]) -> None:
        req = self._req[rid]
        self._generated[rid].append(tok)
        if req.callback is not None:
            try:
                req.callback(rid, tok)
            except Exception as e:  # noqa: BLE001 — user code must not
                # kill the pool: fail only this request, keep serving
                toks = self._generated.pop(rid, [])
                self._rid[slot] = None
                del self._req[rid]
                self.slots.evict(slot)
                self._finalize(
                    req, toks, RequestStatus.FAILED,
                    f"on_token callback raised: {e!r}", finished)
                return
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(self._generated[rid]) >= req.max_new_tokens:
            toks = self._generated.pop(rid)
            self._rid[slot] = None
            del self._req[rid]
            self.slots.evict(slot)
            self._finalize(req, toks, RequestStatus.FINISHED, None, finished)


def _finite_per_slot(state, axes, n: int) -> np.ndarray:
    """[n] bool: slot i's floating leaves are all finite. Integer lanes
    (cursors) are skipped — they cannot hold NaN/Inf."""
    ok = None
    for leaf, ax in zip(state_leaves(state), state_leaves(axes)):
        if not leaf.is_floating_point():
            continue
        fin = torch.isfinite(leaf.movedim(ax, 0).reshape(n, -1)).all(dim=1)
        ok = fin if ok is None else ok & fin
    return ok.cpu().numpy()
