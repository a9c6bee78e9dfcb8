"""Crash and resume of the training drivers, on the CPU (smoke config).

The protocol: run A trains with periodic checkpoints; then the state that a
kill during its final save leaves is built (the final checkpoint removed,
LATEST pointed back at the periodic one, as the atomicity test of
`tests/test_ckpt_ft.py` builds a crashed save), and run B resumes.

- The port labels every checkpoint with the updates it holds, so run B's
  losses and final parameters equal an unbroken run's bit for bit.
- The reference labels a periodic save one short (`src/repro/launch/
  train.py:151-152`): its resumed run applies the batch at the label a
  second time. This is the recorded divergence.
- A run begun in the reference, stopped at a step boundary by a
  preemption, continues in the port.
"""
import os

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.launch import train as JT  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.optim.grad_utils import leaves  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

# the step-3 loss of a run the port continues from the reference's
# checkpoint, against the reference's own: float32 models on both sides,
# as the drivers build them; tests/test_torch_train.py's LOSS_TOL
LOSS_TOL = 1e-6
SMOKE = ["--smoke", "--batch", "2", "--seq", "32", "--log-every", "1"]


def _crash_after_periodic_save(ckpt_dir, periodic: int, final: int):
    """What a kill during the final save leaves: only the periodic
    checkpoint, and LATEST pointing at it."""
    import shutil

    shutil.rmtree(os.path.join(ckpt_dir, f"step_{final:08d}"))
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(f"step_{periodic:08d}")


def _step_leaf(ckpt_dir, label) -> int:
    """The optimizer `step` stored in checkpoint `label` (path `1/.step`)."""
    import json

    d = os.path.join(ckpt_dir, f"step_{label:08d}")
    files = {m["path"]: m["file"] for m in
             json.load(open(os.path.join(d, "manifest.json")))["leaves"]}
    return int(np.load(os.path.join(d, "arrays", files["1/.step"])))


def _port(argv):
    return TT.main(SMOKE + ["--device", "cpu"] + argv)


def test_port_resume_equals_an_unbroken_run_bit_for_bit(tmp_path):
    """Run A, unbroken (its saves copy the state and change nothing),
    against run B, resumed from A's periodic checkpoint."""
    ck = str(tmp_path)
    run = ["--attn", "fastmax2-kernel", "--steps", "6"]
    params_a, losses_a = _port(run + ["--ckpt-dir", ck, "--ckpt-every", "3"])
    assert _step_leaf(ck, 3) == 3 and _step_leaf(ck, 6) == 6
    _crash_after_periodic_save(ck, 3, 6)
    params_b, losses_b = _port(run + ["--ckpt-dir", ck, "--resume"])
    assert len(losses_a) == 6 and losses_b == losses_a[3:]
    for (name, a), (_, b) in zip(leaves(params_a), leaves(params_b)):
        assert torch.equal(a, b), name


def _spy_losses(monkeypatch):
    """Every loss the reference's driver computes, at full precision (it
    prints four decimals)."""
    seen = []
    real = JT.make_train_step

    def factory(cfg, optimizer):
        step = real(cfg, optimizer)

        def wrapped(params, opt_state, batch):
            params, opt_state, m = step(params, opt_state, batch)
            jax.debug.callback(lambda x: seen.append(float(x)), m["loss"])
            return params, opt_state, m
        return wrapped

    monkeypatch.setattr(JT, "make_train_step", factory)
    return seen


def _jax(argv, seen):
    seen.clear()
    JT.main(SMOKE + argv)
    jax.effects_barrier()
    return list(seen)


def test_reference_resume_repeats_the_batch_at_its_label(tmp_path,
                                                        monkeypatch):
    """The divergence: the reference's periodic checkpoint labelled 3
    holds 4 updates, and its resumed run takes batch 3 again, so its step-3
    loss is not the unbroken run's."""
    ck = str(tmp_path)
    seen = _spy_losses(monkeypatch)
    losses_a = _jax(["--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3"],
                    seen)
    assert len(losses_a) == 6
    assert _step_leaf(ck, 3) == 4          # label one short of .step
    assert _step_leaf(ck, 6) == 6          # the final save is right
    _crash_after_periodic_save(ck, 3, 6)
    losses_b = _jax(["--steps", "6", "--ckpt-dir", ck, "--resume"], seen)
    assert len(losses_b) == 3
    assert abs(losses_b[0] - losses_a[3]) > 1e-4


class _PreemptAfter3:
    """A PreemptionHandler whose signal arrives during step 2: the loop
    sees it at the boundary before step 3."""

    def __init__(self, *a, **kw):
        self.checks = 0

    @property
    def requested(self):
        self.checks += 1
        return self.checks > 3

    def restore(self):
        pass


def test_a_run_begun_in_the_reference_continues_in_the_port(tmp_path,
                                                           monkeypatch):
    ck = str(tmp_path)
    seen = _spy_losses(monkeypatch)
    unbroken = _jax(["--steps", "4"], seen)
    monkeypatch.setattr(JT, "PreemptionHandler", _PreemptAfter3)
    begun = _jax(["--steps", "4", "--ckpt-dir", ck], seen)
    assert begun == unbroken[:3]
    assert _step_leaf(ck, 3) == 3          # a preemption save is right
    _, losses = _port(["--steps", "4", "--ckpt-dir", ck, "--resume"])
    assert len(losses) == 1
    assert abs(losses[0] - unbroken[3]) <= LOSS_TOL * abs(unbroken[3])
