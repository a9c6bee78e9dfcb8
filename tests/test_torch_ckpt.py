"""Port of `tests/test_ckpt_ft.py` (checkpointing and fault tolerance) and
the carry-across of checkpoints between the two packages: both write the
same on-disk format, so a (params, opt_state) checkpoint written by either
restores in the other, bfloat16 leaves bit for bit.

The reference's elastic-resharding case (`test_elastic_restore_resharding`,
restore onto another mesh) is part of `tests/test_torch_cp_train.py`: a
checkpoint written by a context-parallel run (`--cp 2`, two gloo ranks)
resumes in a single-process one and the other way round, the weights and
optimizer state being replicated on every rank.
"""
import dataclasses
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as JC
from repro.configs import get_smoke_config as jsmoke
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.models import init_model as jinit
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              load_checkpoint, save_checkpoint)
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.ft import (PreemptionHandler, StragglerMonitor,
                            run_with_restarts)
from repro_torch.launch import steps as TS
from repro_torch.models import init_model
from repro_torch.models.param import from_jax_params
from repro_torch.optim import OptState
from torch_threads import share_cores  # noqa: F401,E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(8, 4, generator=g),
        "b": {"scale": torch.randn(4, generator=g).to(torch.bfloat16),
              "f8": torch.randn(3, generator=g).to(torch.float8_e4m3fn)},
        "step": torch.tensor(7, dtype=torch.int32),
        "pair": (torch.arange(3, dtype=torch.int64), None),
    }


def _assert_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 100, t, extra={"note": "x"})
    restored, step, extra = load_checkpoint(str(tmp_path), t)
    assert step == 100 and extra["note"] == "x"
    assert restored["pair"][1] is None
    _assert_equal(t, restored)
    manifest = json.load(open(tmp_path / "step_00000100" / "manifest.json"))
    assert {m["path"]: m["dtype"] for m in manifest["leaves"]} == {
        "b/f8": "float8_e4m3fn", "b/scale": "bfloat16", "pair/0": "int64",
        "step": "int32", "w": "float32"}


def test_atomicity_partial_save_ignored(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    # a crashed later save: its tmp dir exists but LATEST was not updated
    os.makedirs(tmp_path / ".tmp_step_00000002/arrays", exist_ok=True)
    _, step, _ = load_checkpoint(str(tmp_path), t)
    assert step == 1 and latest_step(str(tmp_path)) == 1


def test_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t, block=False)
    mgr.wait()
    assert not mgr.writing
    tags = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert tags == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4


def test_async_save_snapshots_before_returning(tmp_path):
    """The in-place optimizer overwrites the leaves as soon as `save`
    returns: the checkpoint holds the values at the call."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.zeros(1000)}
    mgr.save(1, t, block=False)
    t["w"].add_(1.0)
    mgr.wait()
    restored, _, _ = mgr.restore(t)
    assert torch.equal(restored["w"], torch.zeros(1000))


def test_run_with_restarts_recovers(tmp_path):
    """Injected worker failure: the supervisor restores from the checkpoint
    and finishes."""
    mgr = CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def make_state():
        params = {"w": torch.zeros(2)}
        start = 0
        if mgr.latest_step() is not None:
            (params,), start, _ = mgr.restore((params,))
        return params, start

    def run(params, start):
        calls["n"] += 1
        for step in range(start, 10):
            params = {"w": params["w"] + 1.0}
            mgr.save(step + 1, (params,))
            if calls["n"] == 1 and step == 4:
                raise RuntimeError("node lost")
        return int(params["w"][0])

    seen = []
    total = run_with_restarts(make_state, run, max_restarts=3,
                              on_restart=lambda n, e: seen.append((n, e)))
    assert total == 10          # 5 steps before the crash, then 5..9
    assert calls["n"] == 2 and seen[0][0] == 1
    with pytest.raises(RuntimeError, match="always"):
        run_with_restarts(lambda: (), lambda: (_ for _ in ()).throw(
            RuntimeError("always")), max_restarts=2)


def test_preemption_handler_sets_its_flag_and_restores_the_old_handler():
    assert threading.current_thread() is threading.main_thread()
    seen = []
    old = signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        pre = PreemptionHandler()
        assert not pre.requested
        signal.raise_signal(signal.SIGTERM)
        assert pre.requested and not seen
        pre.restore()
        signal.raise_signal(signal.SIGTERM)     # the old handler again
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0, patience=2)
    for _ in range(10):
        mon.start_step()
        mon._t0 -= 0.01          # 10 ms steps
        mon.end_step()
    assert not mon.straggling
    for _ in range(2):
        mon.start_step()
        mon._t0 -= 0.1           # 100 ms: 10x the median
        mon.end_step()
    assert mon.straggling and mon.stats()["median_s"] > 0


# ---------------------------------------------------------------------------
# carry-across: one format in both packages
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    """A leaf's bytes (torch or numpy/JAX), for bit-for-bit comparisons."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def test_leaf_dtypes_carry_across_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    jt = {"w": jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
          "b": {"scale": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16),
                "f8": jnp.asarray(rng.normal(size=(6,)), jnp.float8_e4m3fn)},
          "step": jnp.asarray(9, jnp.int32)}
    JC.save_checkpoint(str(tmp_path / "j"), 3, jt)
    like = {"w": torch.zeros(5, 3), "step": torch.zeros((), dtype=torch.int32),
            "b": {"scale": torch.zeros(4, dtype=torch.bfloat16),
                  "f8": torch.zeros(6, dtype=torch.float8_e4m3fn)}}
    tt, step, _ = load_checkpoint(str(tmp_path / "j"), like)
    assert step == 3
    want = dict(zip(["b/f8", "b/scale", "step", "w"], jax.tree.leaves(jt)))
    for path, x in _flatten(tt):
        assert str(x.dtype) == f"torch.{want[path].dtype}", path
        np.testing.assert_array_equal(_bits(x), _bits(want[path]))
    save_checkpoint(str(tmp_path / "t"), 4, tt)
    back, step, _ = JC.load_checkpoint(str(tmp_path / "t"), jt)
    assert step == 4
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _jax_trained(dtype, steps=2):
    """The JAX smoke model's (params, opt_state) after `steps` AdamW steps,
    and the port's config for it."""
    over = dict(param_dtype=dtype, activ_dtype=dtype)
    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"), **over)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), **over)
    jparams, _ = jinit(jax.random.PRNGKey(0), jcfg)
    _, opt = JS.pick_optimizer(jcfg, 1e6, lr=3e-3, total_steps=10)
    jstate = opt[0](jparams)
    step = jax.jit(JS.make_train_step(jcfg, opt))
    data = JSyntheticLM(jcfg.vocab_size, 16, seed=0)
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(s, 2).items()}
        jparams, jstate, _ = step(jparams, jstate, batch)
    return jcfg, tcfg, jparams, jstate


def _port_like(tcfg):
    params = init_model(tcfg, seed=1, device="cpu")
    _, opt = TS.pick_optimizer(tcfg, 1e6, lr=3e-3, total_steps=10)
    return params, opt[0](params)


def _as_port(jparams, jstate, tcfg):
    """The JAX tree as the port holds it: params through from_jax_params,
    the optimizer state leaf by leaf in its own dtypes."""
    def conv(tree):
        if tree is None:
            return None
        return jax.tree.map(lambda x: _torch(np.asarray(x)), tree)

    params = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return params, OptState(_torch(np.asarray(jstate.step)), conv(jstate.m),
                            conv(jstate.v), conv(jstate.master))


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_checkpoint_carries_across_both_ways(tmp_path, dtype):
    jcfg, tcfg, jparams, jstate = _jax_trained(dtype)
    assert (jstate.master is None) == (dtype == "float32")
    JC.save_checkpoint(str(tmp_path / "j"), 2, (jparams, jstate))
    like = _port_like(tcfg)
    tree, step, _ = load_checkpoint(str(tmp_path / "j"), like)
    assert step == 2 and int(tree[1].step) == 2
    manifest = json.load(open(tmp_path / "j" / "step_00000002" /
                              "manifest.json"))
    assert [m["path"] for m in manifest["leaves"]] == [
        p for p, _ in _flatten(like)]
    _assert_equal(_as_port(jparams, jstate, tcfg), tree)
    if dtype == "bfloat16":
        assert tree[0]["embed"].dtype == torch.bfloat16

    save_checkpoint(str(tmp_path / "t"), 2, tree)
    assert json.load(open(tmp_path / "t" / "step_00000002" /
                          "manifest.json"))["leaves"] == manifest["leaves"]
    back, step, _ = JC.load_checkpoint(str(tmp_path / "t"),
                                       (jparams, jstate))
    assert step == 2
    for a, b in zip(jax.tree.leaves((jparams, jstate)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))

