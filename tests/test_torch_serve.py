"""Port parity of the continuous-batching engine (`repro_torch.serve`),
the port's counterpart of `tests/test_serve.py` (`serve` marker).

The contract: the engine (staggered admissions, chunked prefill mixed
with batched decode, slot reuse) gives exactly the tokens the port's
`launch.serve.generate` gives per request, for every decode-capable
backend, on the GQA smoke config; and exactly the JAX engine's tokens on
the same weights. The smoke model with tied embeddings echoes the last
prompt token under greedy decoding (in both packages), so the parity
cases use its untied head, whose tokens follow the whole hidden state.
Plus two contracts of the port's in-place state: a slot that is not
decoding comes out of a decode tick bit for bit, and a prefix-cache
snapshot does not change under later ticks. The SSM-mixer cases of the
reference wait for those mixers.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serve import (PrefixCache, Request, Scheduler,  # noqa: E402
                               ServeEngine)
from repro_torch.attention.state import map_state, state_leaves  # noqa: E402,E501
from repro_torch.serve.slots import SlotManager, to_slotted  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

pytestmark = pytest.mark.serve

DECODE_SPECS = ["softmax", "fastmax1-chunked", "fastmax2-chunked",
                "fastmax2-kernel", "hybrid2-chunked"]


def _cfg(spec_name="fastmax2-chunked", tied=False):
    cfg = get_smoke_config("qwen3-1.7b", tie_embeddings=tied)
    return dataclasses.replace(cfg, attn=AttentionSpec.parse(spec_name))


def _setup(spec_name="fastmax2-chunked", tied=False, seed=0):
    cfg = _cfg(spec_name, tied)
    return cfg, init_model(cfg, seed=seed, device="cpu")


def _ref(params, cfg, prompt, gen, max_len, eos_id=None):
    prompts = torch.as_tensor(prompt[None], dtype=torch.int64)
    return generate(params, cfg, prompts, gen, max_len=max_len,
                    eos_id=eos_id, device="cpu")[0].numpy()


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _equal_states(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                   state_leaves(b)))


# ---------------------------------------------------------------------------
# slot pool unit behavior
# ---------------------------------------------------------------------------


def _fresh_unit(cfg, max_len):
    from repro_torch.models import init_decode_state
    return to_slotted(init_decode_state(cfg, 1, max_len, device="cpu"))


def test_slot_write_read_roundtrip():
    cfg = _cfg("fastmax2-chunked")
    sm = SlotManager(cfg, max_slots=3, max_len=32, device="cpu")
    fresh = _fresh_unit(cfg, 32)
    unit = map_state(lambda t: torch.full_like(t, 7), fresh)
    sm.admit(1, unit_state=unit)
    assert _equal_states(sm.snapshot(1), unit)
    assert _equal_states(sm.snapshot(0), fresh)   # neighbours kept
    assert _equal_states(sm.snapshot(2), fresh)


@pytest.mark.parametrize("spec", ["softmax", "fastmax2-chunked",
                                  "hybrid2-chunked"])
@pytest.mark.parametrize("how", ["admit", "quarantine"])
def test_slot_reset_in_place_gives_a_fresh_state(spec, how):
    """A cold admit and a quarantine fill the slot's rows with the fresh
    state's values in place (zeros; ones in the softmax mask lane),
    leaving the other slots as they were; no fresh template is kept."""
    cfg = _cfg(spec)
    sm = SlotManager(cfg, max_slots=3, max_len=32, device="cpu")
    used = map_state(lambda t: torch.full_like(t, 7), _fresh_unit(cfg, 32))
    for s in range(3):
        sm.admit(s, unit_state=used)
    ptrs = [t.data_ptr() for t in state_leaves(sm.state)]
    getattr(sm, how)(1)
    assert _equal_states(sm.snapshot(1), _fresh_unit(cfg, 32))
    assert _equal_states(sm.snapshot(0), used)
    assert _equal_states(sm.snapshot(2), used)
    assert [t.data_ptr() for t in state_leaves(sm.state)] == ptrs
    assert not any(isinstance(v, (dict, tuple)) for v in vars(sm).values()
                   if v is not sm.state and v is not sm.axes
                   and v is not sm.fills)


@pytest.mark.parametrize("spec", ["softmax", "fastmax2-chunked",
                                  "hybrid2-chunked"])
def test_slot_axes_cover_every_leaf(spec):
    """Every leaf has one slot axis (1, in the stacked layout), the KV
    cursors included once slotted ([n_layers] -> [n_layers, B])."""
    cfg = _cfg(spec)
    sm = SlotManager(cfg, max_slots=2, max_len=32, device="cpu")
    leaves, axes = state_leaves(sm.state), state_leaves(sm.axes)
    assert len(leaves) == len(axes) and set(axes) == {1}
    kv = sm.state["blocks_0"].kv
    if kv is not None:
        assert tuple(kv.length.shape) == (cfg.n_layers, 2)


def test_to_slotted_keeps_a_fastmax_state():
    cfg = _cfg("fastmax2-chunked")
    from repro_torch.models import init_decode_state
    st = init_decode_state(cfg, 2, 16, device="cpu")
    assert to_slotted(st)["blocks_0"].moments is st["blocks_0"].moments


def test_slot_memory_constant_for_fastmax():
    f = SlotManager(_cfg("fastmax2-chunked"), 1, 128, device="cpu")
    f_big = SlotManager(_cfg("fastmax2-chunked"), 1, 8192, device="cpu")
    s = SlotManager(_cfg("softmax"), 1, 128, device="cpu")
    s_big = SlotManager(_cfg("softmax"), 1, 8192, device="cpu")
    assert f.state_bytes_per_slot() == f_big.state_bytes_per_slot()
    assert s_big.state_bytes_per_slot() > 32 * s.state_bytes_per_slot()


# ---------------------------------------------------------------------------
# engine vs generate(): token parity
# ---------------------------------------------------------------------------


def _staggered(eng, p0, p1, gen):
    r0 = eng.submit(p0, gen)
    outs = {}
    for _ in range(3):                      # p1 arrives mid-flight
        for f in eng.step():
            outs[f.rid] = f.tokens
    r1 = eng.submit(p1, gen)
    outs.update(eng.run())
    return outs[r0], outs[r1]


@pytest.mark.parametrize("spec", DECODE_SPECS)
def test_engine_parity_staggered(spec):
    """Staggered admissions + ragged prompts produce generate()'s tokens
    for every decode-capable backend (GQA config)."""
    cfg, params = _setup(spec)
    assert cfg.n_kv_heads < cfg.n_heads
    p0, p1 = _prompts(cfg, (40, 23), seed=1)
    gen = 6
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    got0, got1 = _staggered(eng, p0, p1, gen)
    np.testing.assert_array_equal(got0, _ref(params, cfg, p0, gen, 64))
    np.testing.assert_array_equal(got1, _ref(params, cfg, p1, gen, 64))
    assert len(set(got0.tolist())) > 1       # the tokens are not an echo


def test_engine_parity_tied_smoke_config():
    """The smoke config as the reference tests it (tied embeddings)."""
    cfg, params = _setup("fastmax2-kernel", tied=True)
    p0, p1 = _prompts(cfg, (40, 23), seed=1)
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    got0, got1 = _staggered(eng, p0, p1, 6)
    np.testing.assert_array_equal(got0, _ref(params, cfg, p0, 6, 64))
    np.testing.assert_array_equal(got1, _ref(params, cfg, p1, 6, 64))


@pytest.mark.parametrize("spec", ["fastmax2-chunked", "softmax",
                                  "hybrid2-chunked"])
def test_engine_slot_reuse_single_slot(spec):
    """max_slots=1 serving 3 queued requests: each admit fully overwrites
    the evicted slot — no state leaks between tenants."""
    cfg, params = _setup(spec)
    prompts = _prompts(cfg, (19, 40, 8), seed=3)
    gen = 4
    refs = [_ref(params, cfg, p, gen, 64) for p in prompts]
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    rids = [eng.submit(p, gen) for p in prompts]
    outs = eng.run()
    for rid, ref in zip(rids, refs):
        np.testing.assert_array_equal(outs[rid], ref)


@pytest.mark.parametrize("spec", ["softmax", "fastmax2-kernel",
                                  "hybrid2-chunked"])
def test_engine_ragged_last_chunk_at_the_end_of_the_cache(spec):
    """A prompt whose last chunk, padded to the chunk size, would run past
    max_len (37 tokens in chunks of 16, max_len 41): the engine prefills
    that chunk at its own 5 tokens, so the softmax cache is never written
    past its last row, and the tokens are generate()'s."""
    cfg, params = _setup(spec)
    prompt = _prompts(cfg, (37,), seed=5)[0]
    eng = ServeEngine(params, cfg, max_slots=2, max_len=41)
    rid = eng.submit(prompt, 4)
    outs = eng.run()
    np.testing.assert_array_equal(outs[rid], _ref(params, cfg, prompt, 4,
                                                  41))
    assert eng.stats()["prefill_tokens"] == 37


def test_prefill_chunks_run_at_their_own_length(monkeypatch):
    """Each prefill part hands lm_prefill exactly the chunk's tokens, the
    ragged last one unpadded and with no kv_mask."""
    import repro_torch.serve.engine as engine_mod

    cfg, params = _setup("fastmax2-kernel")
    seen = []
    real = engine_mod.lm_prefill

    def spy(params_, tokens, cfg_, state, **kw):
        seen.append((tuple(tokens.shape), kw.get("offset"),
                     kw.get("kv_mask")))
        return real(params_, tokens, cfg_, state, **kw)

    monkeypatch.setattr(engine_mod, "lm_prefill", spy)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    eng.submit(_prompts(cfg, (37,), seed=6)[0], 2)
    eng.run()
    assert seen == [((1, 16), 0, None), ((1, 16), 16, None),
                    ((1, 5), 32, None)]


@pytest.mark.parametrize("spec", ["softmax", "fastmax2-kernel"])
def test_engine_matches_the_jax_engine(spec):
    """The port's engine and the reference's, the same weights
    (`from_jax_params`) and the same traffic: identical tokens."""
    from repro.attention import AttentionSpec as JSpec
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import init_model as jinit
    from repro.serve import ServeEngine as JEngine
    from repro_torch.models.param import from_jax_params

    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"), attn=JSpec.parse(spec),
                               tie_embeddings=False)
    cfg = _cfg(spec)
    jparams, _ = jinit(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = _prompts(cfg, (40, 23, 9), seed=1)

    def drive(engine, p, c):
        eng = engine(p, c, max_slots=2, max_len=64)
        rids, outs = [eng.submit(prompts[0], 6)], {}
        for _ in range(3):
            for f in eng.step():
                outs[f.rid] = f.tokens
        rids += [eng.submit(pr, 6) for pr in prompts[1:]]
        outs.update(eng.run())
        return [np.asarray(outs[r]) for r in rids]

    for got, want in zip(drive(ServeEngine, params, cfg),
                         drive(JEngine, jparams, jcfg)):
        np.testing.assert_array_equal(got, want)


def test_prefill_round_robin_interleaves():
    """Two equal prompts admitted together make chunk-for-chunk progress
    (round-robin), and parity survives the interleaving."""
    cfg, params = _setup()
    p0, p1 = _prompts(cfg, (24, 24), seed=7)
    gen = 4
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64, chunk=8)
    r0 = eng.submit(p0, gen)
    r1 = eng.submit(p1, gen)
    eng.step()
    eng.step()
    pos = np.asarray(eng.slots.position)
    assert pos[0] > 0 and pos[1] > 0, pos
    outs = eng.run()
    np.testing.assert_array_equal(outs[r0], _ref(params, cfg, p0, gen, 64))
    np.testing.assert_array_equal(outs[r1], _ref(params, cfg, p1, gen, 64))


def test_submit_rejects_empty_prompt_and_zero_gen():
    cfg, params = _setup()
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.submit(np.arange(4, dtype=np.int32), 0)
    assert eng.pending == 0


def test_engine_refuses_encoder_decoder():
    cfg = get_smoke_config("whisper-small")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine({"embed": torch.zeros(1)}, cfg)


# ---------------------------------------------------------------------------
# the port's in-place state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["fastmax2-kernel", "softmax"])
def test_slots_not_decoding_come_out_of_a_tick_bit_identical(spec):
    """A decode tick folds a token into every slot's state in place; the
    engine restores each occupied slot that is not decoding. Slot 0
    decodes; slots 1 and 2 hold multi-chunk prompts prefilled in turns: in
    each tick the one not being prefilled (mid-prefill, or admitted and
    not started) must keep its state bit for bit."""
    cfg, params = _setup(spec)
    a, b, c = _prompts(cfg, (8, 24, 24), seed=31)
    eng = ServeEngine(params, cfg, max_slots=3, max_len=64, chunk=8)
    ra = eng.submit(a, 8)
    eng.step()                              # a prefilled, first token
    assert eng.status(ra).value == "decode"
    eng.submit(b, 4)
    eng.submit(c, 4)
    for idle in (2, 1, 2, 1):               # slot prefilled: the other one
        before = eng.slots.snapshot(idle)
        pos = eng.slots.position.copy()
        eng.step()
        assert eng.slots.position[idle] == pos[idle]
        assert eng.slots.position[3 - idle] == pos[3 - idle] + 8
        assert _equal_states(eng.slots.snapshot(idle), before)
    outs = eng.run()
    np.testing.assert_array_equal(outs[ra], _ref(params, cfg, a, 8, 64))


def test_prefix_cache_snapshot_unchanged_by_later_ticks():
    """A prefix-cache entry is a copy, not a view into the pool that later
    ticks update in place."""
    cfg, params = _setup("fastmax2-kernel")
    shared = _prompts(cfg, (2 * cfg.chunk_size,), seed=41)[0]
    a = np.concatenate([shared, _prompts(cfg, (5,), seed=42)[0]])
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64,
                      prefix_cache_bytes=1 << 30)
    eng.submit(a, 8)
    eng.run()
    entries = list(eng.prefix_cache._entries.values())
    assert len(entries) == 2
    kept = [state_leaves(s) for _, s, _ in entries]
    copies = [[t.clone() for t in leaves] for leaves in kept]
    pool = {t.untyped_storage().data_ptr()
            for t in state_leaves(eng.slots.state)}
    assert not {t.untyped_storage().data_ptr() for leaves in kept
                for t in leaves} & pool
    eng.submit(_prompts(cfg, (37,), seed=43)[0], 8)   # reuses the slot
    eng.run()
    for leaves, saved in zip(kept, copies):
        assert all(torch.equal(x, y) for x, y in zip(leaves, saved))


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["fastmax2-chunked", "softmax"])
def test_prefix_cache_hit_matches_cold_path(spec):
    """A request resumed from a cached prefix snapshot decodes the exact
    cold-path tokens, stepped out to 64 tokens."""
    cfg, params = _setup(spec)
    c = cfg.chunk_size
    shared = _prompts(cfg, (2 * c,), seed=4)[0]
    a = np.concatenate([shared, _prompts(cfg, (5,), seed=5)[0]])
    b = np.concatenate([shared, _prompts(cfg, (9,), seed=6)[0]])
    gen = 64
    max_len = len(b) + gen
    ref_b = _ref(params, cfg, b, gen, max_len)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=max_len,
                      prefix_cache_bytes=1 << 30)
    eng.submit(a, gen)
    eng.run()
    rb = eng.submit(b, gen)
    outs = eng.run()
    assert eng.prefix_cache.hits >= 1
    np.testing.assert_array_equal(outs[rb], ref_b)


def test_prefix_cache_lru_byte_budget():
    cache = PrefixCache(byte_budget=100, chunk=4)
    state1 = {"x": torch.zeros(10, dtype=torch.float32)}   # 40 bytes
    p1 = np.arange(8, dtype=np.int32)
    p2 = np.arange(100, 108, dtype=np.int32)
    p3 = np.arange(200, 208, dtype=np.int32)
    cache.insert(p1, 4, state1)
    cache.insert(p2, 4, state1)
    assert cache.bytes == 80 and len(cache) == 2
    cache.insert(p3, 4, state1)                # 120 > 100: evicts oldest
    assert cache.bytes == 80 and len(cache) == 2
    assert cache.lookup(p1)[1] is None
    assert cache.lookup(p3)[1] is not None
    cache.insert(np.arange(300, 308, dtype=np.int32), 4,
                 {"x": torch.zeros(100, dtype=torch.float32)})
    assert cache.bytes == 80                   # oversized: refused


def test_prefix_cache_stats_transitions():
    cache = PrefixCache(byte_budget=100, chunk=4)
    state = {"x": torch.zeros(10, dtype=torch.float32)}
    assert cache.lookup(np.arange(3, dtype=np.int32)) == (0, None)
    assert cache.lookup(np.arange(4, dtype=np.int32)) == (0, None)
    assert cache.stats()["misses"] == 0
    p = np.arange(8, dtype=np.int32)
    assert cache.lookup(p) == (0, None)
    assert cache.stats()["misses"] == 1
    cache.insert(p, 4, state)
    m, snap = cache.lookup(p)
    assert m == 4 and snap is state
    assert cache.stats() == {"entries": 1, "bytes": 40, "hits": 1,
                             "misses": 1, "insertions": 1, "evictions": 0}
    cache.insert(np.arange(100, 108, dtype=np.int32), 4, state)
    cache.insert(np.arange(200, 208, dtype=np.int32), 4, state)
    st = cache.stats()
    assert st["insertions"] == 3 and st["evictions"] == 1
    assert st["entries"] == 2 and st["bytes"] == 80


def test_prefix_cache_resume_is_strictly_shorter():
    cache = PrefixCache(byte_budget=1 << 20, chunk=4)
    p = np.arange(8, dtype=np.int32)
    cache.insert(p, 8, {"x": torch.zeros(2)})
    assert cache.lookup(p) == (0, None)


# ---------------------------------------------------------------------------
# scheduler policies
# ---------------------------------------------------------------------------


def _req(rid, plen, tick=0):
    return Request(rid=rid, prompt=np.zeros(plen, np.int32),
                   max_new_tokens=1, submit_tick=tick)


def test_scheduler_fcfs_order():
    s = Scheduler("fcfs")
    for r in [_req(0, 5), _req(1, 50), _req(2, 10)]:
        s.push(r)
    assert [s.pop(0).rid for _ in range(3)] == [0, 1, 2]


def test_scheduler_lpf_prefers_long_prompts():
    s = Scheduler("lpf", max_wait=100)
    for r in [_req(0, 5), _req(1, 50), _req(2, 10)]:
        s.push(r)
    assert [s.pop(0).rid for _ in range(3)] == [1, 2, 0]


def test_scheduler_lpf_starvation_guard():
    s = Scheduler("lpf", max_wait=10)
    s.push(_req(0, 5, tick=0))
    s.push(_req(1, 50, tick=9))
    s.push(_req(2, 60, tick=9))
    assert s.pop(9).rid == 2
    assert s.pop(10).rid == 0
    assert s.pop(11).rid == 1


def test_scheduler_rejects_unknown_policy():
    with pytest.raises(ValueError):
        Scheduler("priority")


def test_engine_lpf_policy_parity():
    """lpf admission reorders requests, not their tokens."""
    cfg, params = _setup()
    prompts = _prompts(cfg, (9, 30, 17), seed=8)
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, policy="lpf")
    rids = [eng.submit(p, 3) for p in prompts]
    outs = eng.run()
    assert [f.rid for f in eng.history] == [rids[1], rids[2], rids[0]]
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], _ref(params, cfg, p, 3, 64))


# ---------------------------------------------------------------------------
# eos, streaming
# ---------------------------------------------------------------------------


def test_generate_and_engine_eos_early_stop():
    cfg, params = _setup()
    (prompt,) = _prompts(cfg, (20,), seed=5)
    gen = 8
    free = _ref(params, cfg, prompt, gen, 64)
    eos = int(free[2])
    k = int(np.argmax(free == eos))
    stopped = _ref(params, cfg, prompt, gen, 64, eos_id=eos)
    np.testing.assert_array_equal(stopped[:k + 1], free[:k + 1])
    assert (stopped[k:] == eos).all()
    eng = ServeEngine(params, cfg, max_slots=1, max_len=64, eos_id=eos)
    rid = eng.submit(prompt, gen)
    np.testing.assert_array_equal(eng.run()[rid], free[:k + 1])


def test_stream_yields_tokens_in_order():
    cfg, params = _setup()
    (prompt,) = _prompts(cfg, (21,), seed=6)
    ref = _ref(params, cfg, prompt, 5, 64)
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    got = list(eng.stream(prompt, 5))
    np.testing.assert_array_equal(np.asarray(got, np.int32), ref)


# ---------------------------------------------------------------------------
# host traffic and the CLI
# ---------------------------------------------------------------------------


def test_tick_reads_back_once(monkeypatch):
    """One device-to-host read per tick, whatever its parts (the deep
    state check off)."""
    cfg, params = _setup("fastmax2-kernel")
    eng = ServeEngine(params, cfg, max_slots=2, max_len=64)
    for p in _prompts(cfg, (30, 12, 7), seed=9):
        eng.submit(p, 5)
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append(1)
                        or real(self, *a, **k))
    ticks = 0
    while eng.pending:
        before = len(calls)
        eng.step()
        ticks += 1
        assert len(calls) - before == 1
    st = eng.stats()
    assert st["prefill_ticks"] + st["decode_ticks"] >= ticks
    assert st["finished"] == 3


def test_serve_cli_engine_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--serve-engine", "--smoke", "--device", "cpu", "--attn",
                "fastmax2-kernel", "--batch", "3", "--prompt-len", "20",
                "--gen", "4", "--slots", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[engine]")]
    assert len(lines) == 2
    assert "generated 12 tokens" in lines[0]
    assert "finished 6" in lines[1] and "failed 0" in lines[1]


def test_serve_cli_engine_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--serve-engine", "--smoke"])
