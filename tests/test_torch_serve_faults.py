"""Port of `tests/test_serve_faults.py`: the chaos tier of the port's
serving engine (`repro_torch.serve`, `faults` marker).

The contract under test: injected faults — NaN into a slot's state, a
user callback that raises, burst overload, expired deadlines, mid-stream
cancellation, wedged host lanes — must fail ONLY the targeted request,
with the correct `RequestStatus` and a diagnostic, while every unaffected
request produces tokens BYTE-IDENTICAL to an undisturbed run. The engine
itself never crashes; it degrades (reject/shed) or raises the structured
`EngineStalled` with a snapshot when it genuinely cannot make progress.

All faults are scheduled by engine tick (`serve/faults.py`), so every
scenario here is exactly reproducible. The smoke config runs with an
untied head, so its greedy tokens follow the whole hidden state
(`tests/test_torch_serve.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import init_model
from repro_torch.serve import (EngineOverloaded, EngineStalled, FaultInjector,
                               PrefixCache, RequestStatus, ServeEngine)
from repro_torch.serve.faults import burst, exploding_callback, poison_slot
from repro_torch.attention.state import state_leaves
from repro_torch.serve.slots import SlotManager
from torch_threads import share_cores  # noqa: F401,E402

pytestmark = pytest.mark.faults


@pytest.fixture(scope="module")
def fm():
    """One (cfg, params) pair shared across the tier (fastmax2-chunked on
    the GQA smoke config — the moment-state backend the quarantine guard
    exists for)."""
    cfg = get_smoke_config("qwen3-1.7b", tie_embeddings=False)
    cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(
        "fastmax2-chunked"))
    return cfg, init_model(cfg, seed=0, device="cpu")


def _ref(params, cfg, prompt, gen, max_len):
    prompts = torch.as_tensor(prompt[None], dtype=torch.int64)
    return generate(params, cfg, prompts, gen, max_len=max_len,
                    device="cpu")[0].numpy()


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


# ---------------------------------------------------------------------------
# callback isolation (satellite: raise on the 3rd token must not kill pool)
# ---------------------------------------------------------------------------


def test_callback_raising_on_third_token_fails_only_its_request(fm):
    cfg, params = fm
    victim, bystander = _prompts(cfg, (14, 11), seed=1)
    G = 6
    ref = _ref(params, cfg, bystander, G, 64)
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    rv = eng.submit(victim, G, callback=exploding_callback(3))
    rb = eng.submit(bystander, G)
    outs = eng.run()                       # must not raise

    assert eng.status(rv) is RequestStatus.FAILED
    fin_v = next(f for f in eng.history if f.rid == rv)
    assert "callback raised" in fin_v.error
    assert len(fin_v.tokens) == 3          # the 3rd token was produced
    np.testing.assert_array_equal(outs[rb], ref)   # bystander untouched
    assert eng.status(rb) is RequestStatus.FINISHED

    # the freed slot serves the next tenant correctly
    late = _prompts(cfg, (9,), seed=2)[0]
    rl = eng.submit(late, G)
    outs = eng.run()
    np.testing.assert_array_equal(outs[rl], _ref(params, cfg, late, G, 64))


# ---------------------------------------------------------------------------
# submit() validation (satellite: context bound, eos_id type/sign)
# ---------------------------------------------------------------------------


def test_submit_rejects_overlong_prompt_and_bad_eos(fm):
    cfg, params = fm
    eng = ServeEngine(params, cfg, max_slots=1, max_len=32)
    long_prompt = np.zeros(40, np.int32)
    with pytest.raises(ValueError, match="exceeds the model context"):
        eng.submit(long_prompt, 1)
    ok_prompt = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="eos_id must be non-negative"):
        eng.submit(ok_prompt, 4, eos_id=-1)
    with pytest.raises(ValueError, match="eos_id must be an integer"):
        eng.submit(ok_prompt, 4, eos_id=1.5)
    with pytest.raises(ValueError, match="eos_id must be an integer"):
        eng.submit(ok_prompt, 4, eos_id=True)   # bool is always a bug
    with pytest.raises(ValueError, match="ttft_deadline must be >= 0"):
        eng.submit(ok_prompt, 4, ttft_deadline=-1.0)
    assert eng.pending == 0                # nothing was enqueued
    # the engine-level default is validated at construction too
    with pytest.raises(ValueError, match="eos_id must be non-negative"):
        ServeEngine(params, cfg, max_slots=1, max_len=32, eos_id=-7)


# ---------------------------------------------------------------------------
# backpressure: bounded queue + load shedding
# ---------------------------------------------------------------------------


def test_burst_overload_rejects_then_recovers(fm):
    cfg, params = fm
    prompts = _prompts(cfg, (10, 12, 14, 9, 11, 13), seed=3)
    G = 3
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, max_queue=2)
    rids, rejected = burst(eng, prompts, G)
    assert len(rids) == 2 and rejected == 4
    assert eng.stats()["rejected"] == 4
    outs = eng.run()                       # admitted requests complete
    assert all(eng.status(r) is RequestStatus.FINISHED for r in rids)
    for rid, p in zip(rids, prompts[:2]):
        np.testing.assert_array_equal(outs[rid], _ref(params, cfg, p, G, 64))
    # backpressure clears once the queue drains
    r_new = eng.submit(prompts[2], G)
    outs = eng.run()
    np.testing.assert_array_equal(outs[r_new],
                                  _ref(params, cfg, prompts[2], G, 64))


def test_queued_token_budget_rejects(fm):
    cfg, params = fm
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64,
                      max_queue_tokens=20)
    eng.submit(np.zeros(12, np.int32), 1)
    with pytest.raises(EngineOverloaded, match="token budget"):
        eng.submit(np.zeros(12, np.int32), 1)


def test_shed_newest_largest_under_sustained_saturation(fm):
    cfg, params = fm
    # slot 0 is held by a long-running request; the queue sits full for
    # `shed_after` ticks -> the newest/largest waiter is shed with a
    # structured REJECTED record, and the survivors still complete
    prompts = _prompts(cfg, (12, 8, 9, 30), seed=4)   # [3] is the victim
    G = 8
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, max_queue=3,
                      shed_after=2)
    r_hold = eng.submit(prompts[0], G)
    eng.step()                             # r_hold takes the slot
    queued = [eng.submit(p, 2) for p in prompts[1:]]
    victim = queued[-1]                    # largest prompt, newest
    eng.step()                             # saturation tick 1
    fins = eng.step()                      # tick 2: shed kicks in
    shed = [f for f in fins if f.status is RequestStatus.REJECTED]
    assert [f.rid for f in shed] == [victim]
    assert "shed after" in shed[0].error
    assert eng.stats()["shed"] == 1
    outs = eng.run()
    for rid in [r_hold] + queued[:-1]:
        assert eng.status(rid) is RequestStatus.FINISHED
        assert rid in outs


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def test_ttft_deadline_expires_in_queue(fm):
    cfg, params = fm
    p_victim, p_ok = _prompts(cfg, (10, 13), seed=5)
    G = 4
    ref = _ref(params, cfg, p_ok, G, 64)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    rv = eng.submit(p_victim, G, ttft_deadline=0.0)
    rk = eng.submit(p_ok, G)
    outs = eng.run()
    assert eng.status(rv) is RequestStatus.TIMED_OUT
    fin = next(f for f in eng.history if f.rid == rv)
    assert "RequestTimeout" in fin.error and fin.ttft is None
    assert len(fin.tokens) == 0
    np.testing.assert_array_equal(outs[rk], ref)


def test_total_deadline_expires_mid_decode(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (11,), seed=6)
    G = 12
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    rid = eng.submit(prompt, G)
    eng.step()                             # prefill completes, token #1
    eng.step()                             # a decode token
    assert eng.status(rid) is RequestStatus.DECODE
    eng._req[rid].deadline = 1e-9          # expire it mid-flight
    fins = eng.step()
    assert [f.rid for f in fins] == [rid]
    fin = fins[0]
    assert fin.status is RequestStatus.TIMED_OUT
    assert 0 < len(fin.tokens) < G and fin.ttft is not None
    assert eng.stats()["timed_out"] == 1
    assert eng.stats()["slots_occupied"] == 0   # slot was freed


# ---------------------------------------------------------------------------
# non-finite quarantine + lockstep-parity isolation (satellite)
# ---------------------------------------------------------------------------


def test_nan_quarantine_isolates_and_matches_undisturbed_run(fm):
    """Poison one slot mid-decode: that request FAILs with a quarantine
    diagnostic, every other request's tokens are byte-identical to an
    undisturbed engine run, and the quarantined slot serves the next
    tenant exactly."""
    cfg, params = fm
    others = _prompts(cfg, (12, 9, 14), seed=7)
    (victim,) = _prompts(cfg, (10,), seed=8)
    G = 8

    clean = ServeEngine(params, cfg, max_slots=4, max_len=64, chunk=16)
    rids_a = [clean.submit(p, G) for p in others]
    outs_a = clean.run()

    inj = FaultInjector().nan_into_slot(tick=6, slot=3)
    eng = ServeEngine(params, cfg, max_slots=4, max_len=64, chunk=16,
                      faults=inj)
    rids_b = [eng.submit(p, G) for p in others]
    rv = eng.submit(victim, G)             # fcfs: victim lands in slot 3
    outs_b = eng.run()                     # never crashes

    assert inj.log == [(6, "nan_into_slot(3)")]
    assert eng.status(rv) is RequestStatus.FAILED
    fin_v = next(f for f in eng.history if f.rid == rv)
    assert "SlotQuarantined" in fin_v.error
    assert eng.stats()["quarantined"] == 1
    for ra, rb in zip(rids_a, rids_b):
        np.testing.assert_array_equal(outs_b[rb], outs_a[ra])
        assert eng.status(rb) is RequestStatus.FINISHED

    # the re-initialized slot decodes the next tenant bit-exactly
    (late,) = _prompts(cfg, (13,), seed=9)
    rl = eng.submit(late, G)
    outs = eng.run()
    np.testing.assert_array_equal(outs[rl], _ref(params, cfg, late, G, 64))


def test_nan_during_prefill_is_quarantined(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (24,), seed=10)   # 3 chunks at chunk=8
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, chunk=8,
                      faults=FaultInjector().nan_into_slot(tick=2, slot=0))
    rid = eng.submit(prompt, 4)
    eng.run()
    assert eng.status(rid) is RequestStatus.FAILED
    fin = next(f for f in eng.history if f.rid == rid)
    assert "prefill" in fin.error and len(fin.tokens) == 0


def test_quarantine_purges_poisoned_prefix_snapshots(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (20,), seed=11)   # chunk boundary at 8, 16
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, chunk=8,
                      prefix_cache_bytes=1 << 30,
                      faults=FaultInjector().nan_into_slot(tick=2, slot=0))
    rid = eng.submit(prompt, 4)
    eng.run()
    assert eng.status(rid) is RequestStatus.FAILED
    # the tick-1 snapshot (after 8 tokens) must NOT survive to seed a
    # same-prefix request with poisoned state
    assert eng.prefix_cache.lookup(prompt) == (0, None) or \
        eng.prefix_cache.lookup(prompt)[0] == 0


def test_deep_state_check_catches_latent_nan(fm, monkeypatch):
    """REPRO_SERVE_CHECK_STATE=1: a slot poisoned while it is NOT emitting
    (another slot's prefill turn) is caught by the deep leaf check the
    same tick, before its poison can reach logits or the prefix cache."""
    monkeypatch.setenv("REPRO_SERVE_CHECK_STATE", "1")
    cfg, params = fm
    p0, p1 = _prompts(cfg, (24, 24), seed=12)   # 3 chunks each at chunk=8
    # tick 1 prefills slot 0, tick 2 slot 1, tick 3 slot 0 again: poison
    # slot 1 at tick 3, when only slot 0 emits logits
    inj = FaultInjector().nan_into_slot(tick=3, slot=1)
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64, chunk=8,
                      faults=inj)
    r0 = eng.submit(p0, 3)
    r1 = eng.submit(p1, 3)
    outs = eng.run()
    assert eng.status(r1) is RequestStatus.FAILED
    fin = next(f for f in eng.history if f.rid == r1)
    assert "deep check" in fin.error
    np.testing.assert_array_equal(outs[r0], _ref(params, cfg, p0, 3, 64))


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


def test_cancel_mid_decode_isolates_and_matches_undisturbed_run(fm):
    cfg, params = fm
    others = _prompts(cfg, (12, 9), seed=13)
    (victim,) = _prompts(cfg, (10,), seed=14)
    G = 8

    clean = ServeEngine(params, cfg, max_slots=3, max_len=64, chunk=16)
    rids_a = [clean.submit(p, G) for p in others]
    outs_a = clean.run()

    eng = ServeEngine(params, cfg, max_slots=3, max_len=64, chunk=16)
    rids_b = [eng.submit(p, G) for p in others]
    rv = eng.submit(victim, G)
    eng.faults = FaultInjector().cancel_at(tick=6, rid=rv)
    outs_b = eng.run()

    assert eng.status(rv) is RequestStatus.CANCELLED
    fin_v = next(f for f in eng.history if f.rid == rv)
    assert "mid-decode" in fin_v.error and 0 < len(fin_v.tokens) < G
    assert eng.stats()["cancelled"] == 1
    for ra, rb in zip(rids_a, rids_b):
        np.testing.assert_array_equal(outs_b[rb], outs_a[ra])


def test_cancel_queued_and_unknown(fm):
    cfg, params = fm
    p0, p1 = _prompts(cfg, (10, 11), seed=15)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    r0 = eng.submit(p0, 3)
    r1 = eng.submit(p1, 3)                  # stays queued behind r0
    assert eng.cancel(r1) is True
    assert eng.status(r1) is RequestStatus.CANCELLED
    assert eng.cancel(r1) is False          # already terminal
    assert eng.cancel(999) is False         # unknown rid
    outs = eng.run()
    assert r1 not in outs and eng.status(r0) is RequestStatus.FINISHED


def test_cancel_mid_prefill_frees_slot(fm):
    cfg, params = fm
    (long_p,) = _prompts(cfg, (40,), seed=16)   # 5 chunks at chunk=8
    (short_p,) = _prompts(cfg, (9,), seed=17)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, chunk=8)
    rv = eng.submit(long_p, 4)
    eng.step()                              # one prefill chunk in
    assert eng.status(rv) is RequestStatus.PREFILL
    assert eng.cancel(rv) is True
    fin = next(f for f in eng.history if f.rid == rv)
    assert "mid-prefill" in fin.error and len(fin.tokens) == 0
    rs = eng.submit(short_p, 4)             # slot is immediately reusable
    outs = eng.run()
    np.testing.assert_array_equal(outs[rs],
                                  _ref(params, cfg, short_p, 4, 64))


# ---------------------------------------------------------------------------
# watchdog: stalls are structured failures, never silent spins
# ---------------------------------------------------------------------------


def test_run_raises_engine_stalled_at_max_ticks(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (10,), seed=18)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    eng.submit(prompt, 8)                   # needs ~9 ticks
    with pytest.raises(EngineStalled, match="max_ticks=2") as ei:
        eng.run(max_ticks=2)
    snap = ei.value.snapshot
    assert snap is not None and snap["slots"][0]["rid"] is not None


def test_tick_budget_watchdog_trips_on_sustained_slow_ticks(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (10,), seed=19)
    inj = FaultInjector()
    for t in (2, 3, 4, 5, 6):
        inj.slow_tick(t, 0.05)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64,
                      tick_budget_s=0.02, faults=inj)
    eng.submit(prompt, 32)
    with pytest.raises(EngineStalled, match="wall-clock budget") as ei:
        eng.run()
    assert ei.value.snapshot["tick_time"]["max_s"] >= 0.05


def test_no_progress_stall_detected(fm):
    cfg, params = fm
    (prompt,) = _prompts(cfg, (24,), seed=20)   # multi-chunk prefill

    def wedge(eng):
        # simulate a lost wakeup: the slot claims its prompt is done but
        # never went active — no prefill picked, no decode, queue empty
        eng.slots.position[0] = len(prompt)

    inj = FaultInjector().call(2, wedge, name="wedge")
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, chunk=8,
                      stall_ticks=5, faults=inj)
    eng.submit(prompt, 4)
    with pytest.raises(EngineStalled, match="no tick progress") as ei:
        eng.run()
    assert ei.value.snapshot["queue_depth"] == 0
    assert ei.value.snapshot["counters"]["admitted"] == 1


# ---------------------------------------------------------------------------
# prefix-cache invalidation (unit) + stats/lifecycle bookkeeping
# ---------------------------------------------------------------------------


def test_prefix_cache_invalidate_removes_only_that_prompts_prefixes():
    cache = PrefixCache(byte_budget=1 << 20, chunk=4)
    state = {"x": np.zeros(10, np.float32)}
    p = np.arange(12, dtype=np.int32)
    other = np.arange(100, 112, dtype=np.int32)
    cache.insert(p, 4, state)
    cache.insert(p, 8, state)
    cache.insert(other, 4, state)
    assert cache.invalidate(p) == 2
    assert len(cache) == 1 and cache.bytes == 40
    assert cache.lookup(p) == (0, None)
    assert cache.lookup(other)[0] == 4      # unrelated entry survives


def test_stats_and_lifecycle_bookkeeping(fm):
    cfg, params = fm
    p0, p1 = _prompts(cfg, (10, 12), seed=21)
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    r0 = eng.submit(p0, 3)
    assert eng.status(r0) is RequestStatus.QUEUED
    r1 = eng.submit(p1, 3)
    eng.run()
    st = eng.stats()
    assert st["admitted"] == 2 and st["finished"] == 2
    assert st["queue_depth"] == 0 and st["slots_occupied"] == 0
    assert st["slots_total"] == 2 and st["decode_tokens"] > 0
    for f in eng.history:
        assert f.ok and f.status is RequestStatus.FINISHED
        assert f.error is None and f.ttft is not None
    assert {eng.status(r0), eng.status(r1)} == {RequestStatus.FINISHED}


@pytest.mark.parametrize("spec", ["fastmax2-chunked", "softmax",
                                  "hybrid2-chunked"])
def test_poison_slot_touches_only_float_leaves(spec):
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              attn=AttentionSpec.parse(spec))
    sm = SlotManager(cfg, max_slots=2, max_len=32, device="cpu")
    n = poison_slot(sm, 0)
    floats = [t for t in state_leaves(sm.state) if t.is_floating_point()]
    assert n == len(floats) > 0
    for leaf in state_leaves(sm.snapshot(0)):
        if leaf.is_floating_point():
            assert torch.isnan(leaf).all()
        else:                               # cursors stay as they were
            assert (leaf == 0).all()
    # the neighbouring slot is untouched
    for leaf in state_leaves(sm.snapshot(1)):
        if leaf.is_floating_point():
            assert not torch.isnan(leaf).any()
