"""Context-parallel training (`launch/train.py --cp`, `launch/steps.py`)
on gloo worlds of 2 and 4 ranks (the kernels' plain versions on the
CPU), against `--cp 1` in one process, losses and per-leaf grads at
float32 limits:

- the smoke qwen3 on fastmax2-kernel (the seq plan: each rank on its
  token shard): `--cp 2` on two ranks and on a (data 2, seq 2) mesh of
  four, the CLI's losses and the grad fn's, and a checkpoint resumes
  across `--cp 2` and `--cp 1` both ways;
- every other decoder mixer, which takes its sequence gathered over
  "seq" (`placed.cp_enter`, `cp_exit`), as the reference's GSPMD gathers
  it: the smoke qwen3 on softmax, the oracle, rowwise and both hybrid
  backends (the hybrid kernel's wrapper called once a layer on the whole
  sequence, and again in remat's recompute), jamba (Mamba and the MoE
  gathered, its attention on the seq plan), xlstm-1.3b (mLSTM, sLSTM),
  deepseek-v2 (MLA, D = 24 != Dv = 16, on the seq plan; the MoE
  gathered) and kimi-k2 on two ranks, jamba and deepseek-v2 on a (data
  2, seq 2) mesh of four; and the entry/exit pair with the "model"
  split's backward, whose gathered mixer's grads come out `cp` times too
  large;
- the `--cp` argument errors, which configs `check_cp` takes, and its
  one refusal, an encoder-decoder model (the reference's CLI feeds
  whisper no encoder input either), made before any process group.

`--cp 1` itself is held to JAX by `tests/test_torch_archs.py`,
`test_torch_ssm_archs.py`, `test_torch_hybrid_train.py` and
`test_torch_moe.py`."""
import dataclasses
import os
import shutil
import threading

import numpy as np
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_rank_cases
from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.steps import check_cp
from torch_threads import share_cores  # noqa: F401,E402

B, SEQ, STEPS = 2, 32, 4
ARGV = ["--smoke", "--device", "cpu", "--attn", "fastmax2-kernel",
        "--steps", str(STEPS), "--batch", str(B), "--seq", str(SEQ),
        "--lr", "3e-3", "--log-every", "1"]
LOSS_RTOL = 1e-5         # relative, float32 (AdamW steps amplify rounding)
GRAD_RTOL = 1e-4         # per leaf, of its largest |grad|
# xLSTM's input-gate biases (mLSTM's and sLSTM's `bi`) get no gradient in
# exact arithmetic (the output is invariant to a common scale of a head's
# input gates wherever its normalizer is at least 1), so their grads are
# the float32 rounding of the other terms (5e-10 to 1e-8 here, against
# 0.1 for the largest leaf): their scale is at least GRAD_FLOOR of the
# largest leaf's, as in tests/test_torch_ssm_archs.py
GRAD_FLOOR = 1e-2
ZERO_GRAD = "/mixer/bi"


def _grad_args(cp):
    data = SyntheticLM(get_smoke_config("qwen3-1.7b").vocab_size, SEQ,
                       seed=0)
    return dict(arch="qwen3-1.7b", attn="fastmax2-kernel", cp=cp,
                batch=data.batch(0, B))


def _crash_to(ckpt_dir, label: int, final: int):
    """What a kill during the final save leaves: LATEST at `label`."""
    shutil.rmtree(os.path.join(ckpt_dir, f"step_{final:08d}"))
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(f"step_{label:08d}")


def test_cp_train_equals_the_single_process_run(tmp_path):
    """--cp 2 on 2 ranks and on a (2, 2) mesh of 4, spawned at once while
    --cp 1 runs here: the CLI's losses over STEPS AdamW steps and one
    loss and grad of the grad fn, at float32 limits (losses relative
    LOSS_RTOL, each leaf within GRAD_RTOL of its largest |grad|).

    With them the elastic case (the reference's resharding restore): the
    2-rank world also resumes the --cp 1 run's checkpoint of step 2
    (rank 0 reads what one process wrote), and --cp 1 here resumes the
    --cp 2 run's (rank 0 wrote it); both continue to the unbroken --cp 1
    run's losses within LOSS_RTOL. Not bit for bit: the context-parallel
    step sums the moments and the loss in another order."""
    one, two = str(tmp_path / "ckpt1"), str(tmp_path / "ckpt2")
    ckpt = ["--ckpt-every", "2", "--ckpt-dir"]
    _, ref_losses = train.main(ARGV + ckpt + [one])
    _crash_to(one, 2, STEPS)
    runs = {}
    argv = {2: [ARGV + ["--cp", "2"] + ckpt + [two],
                ARGV + ["--cp", "2"] + ckpt + [one, "--resume"]],
            4: [ARGV + ["--cp", "2"]]}

    def spawn(world):
        runs[world] = run_ranks(
            torch_rank_cases.cp_train, world,
            args=(argv[world], _grad_args(2)),
            workdir=tmp_path / f"cp{world}", timeout=300)[0]

    threads = [threading.Thread(target=spawn, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    ref_loss, ref = torch_rank_cases.cp_grads(_grad_args(1))
    for t in threads:
        t.join()
    assert set(runs) == {2, 4}, "a world of ranks failed"
    for world in (2, 4):
        (losses, *_), (loss, grads) = runs[world]
        assert len(losses) == len(ref_losses) == STEPS
        np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL,
                                   atol=0, err_msg=f"world {world}")
        assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), world
        assert sorted(grads) == sorted(ref)
        for name, g in ref.items():
            scale = max(float(np.max(np.abs(g))), 1e-30)
            err = float(np.max(np.abs(grads[name] - g)))
            assert err <= GRAD_RTOL * scale, (world, name, err, scale)
    cp2_resumed = runs[2][0][1]
    _crash_to(two, 2, STEPS)
    _, cp1_resumed = train.main(ARGV + ckpt + [two, "--resume"])
    assert len(cp2_resumed) == len(cp1_resumed) == STEPS - 2
    np.testing.assert_allclose(cp2_resumed, ref_losses[2:], rtol=LOSS_RTOL,
                               atol=0)
    np.testing.assert_allclose(cp1_resumed, ref_losses[2:], rtol=LOSS_RTOL,
                               atol=0)


@pytest.fixture
def fake_world():
    """A single-process fake process group of 2 ranks: `--cp` reads the
    world size from it."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("argv, msg", [
    (["--cp", "3"], r"--cp 3 must divide the world size \(2\)"),
    (["--cp", "2", "--seq", "33"], "--seq 33 must be divisible by --cp 2"),
])
def test_cp_argument_errors(fake_world, argv, msg):
    with pytest.raises(SystemExit, match=msg):
        train.main(ARGV + argv)


# the smoke configs whose mixers take the sequence gathered over "seq"
# (attn None: the config's own, fastmax2-chunked on the seq plan), by the
# worlds that run them
GATHERED = [("qwen3-1.7b", "softmax"), ("qwen3-1.7b", "fastmax2-oracle"),
            ("qwen3-1.7b", "fastmax2-rowwise"),
            ("qwen3-1.7b", "hybrid2-chunked"),
            ("qwen3-1.7b", "hybrid2-kernel"), ("jamba-v0.1-52b", None),
            ("xlstm-1.3b", None), ("deepseek-v2-236b", None),
            ("kimi-k2-1t-a32b", None)]
WORLDS = {2: GATHERED, 4: [("jamba-v0.1-52b", None),
                           ("deepseek-v2-236b", None)]}
SEQ_PLAN = ("jamba-v0.1-52b", "deepseek-v2-236b", "kimi-k2-1t-a32b")
MODEL_BACKWARD = ("qwen3-1.7b", "softmax")


def _args(arch, attn, cp):
    data = SyntheticLM(get_smoke_config(arch).vocab_size, SEQ, seed=0)
    return dict(arch=arch, attn=attn, cp=cp, batch=data.batch(0, B))


def _name(arch, attn):
    return f"{arch}/{attn or 'own'}"


def _grad_errors(tag, got, ref, scale=1.0):
    """The loss and the leaves of `got` (loss, grads) that are not within
    the limits of `scale` x `ref`'s."""
    (loss, grads), (ref_loss, ref_grads) = got, ref
    out = []
    if abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss):
        out.append(f"{tag}: loss {loss} != {ref_loss}")
    if sorted(grads) != sorted(ref_grads):
        return out + [f"{tag}: leaves differ"]
    top = max(float(np.max(np.abs(g))) for g in ref_grads.values())
    for name, g in ref_grads.items():
        g = scale * g
        floor = GRAD_FLOOR * scale * top if name.endswith(ZERO_GRAD) else 0
        lim = GRAD_RTOL * max(float(np.max(np.abs(g))), floor, 1e-30)
        err = float(np.max(np.abs(grads[name] - g)))
        if err > lim:
            out.append(f"{tag}: {name} off by {err:.3e} > {lim:.3e}")
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_cp_gathers_the_other_mixers(world, tmp_path):
    """--cp 2 on a (world / 2, 2) mesh equals --cp 1 for every case of the
    world, one spawn running them all while --cp 1 runs here; every
    failure reported together. In the 2-rank world also the entry/exit
    pair with the "model" split's backward: the gathered mixer's leaves'
    grads are then 2x --cp 1's, the rest equal."""
    cases = [dict(name=_name(a, t), grad_args=_args(a, t, 2))
             for a, t in WORLDS[world]]
    if world == 2:
        cases.append(dict(name="model-backward", model_backward=True,
                          grad_args=_args(*MODEL_BACKWARD, 2)))
    got = []

    def spawn():
        got.append(run_ranks(torch_rank_cases.cp_mixers, world,
                             args=(cases,), workdir=tmp_path,
                             timeout=300)[0])

    t = threading.Thread(target=spawn)
    t.start()
    refs = {_name(a, t_): torch_rank_cases.cp_grads(_args(a, t_, 1))
            for a, t_ in WORLDS[world]}
    t.join()
    assert got, "a rank failed"
    res, errors = got[0], []
    for arch, attn in WORLDS[world]:
        name = _name(arch, attn)
        loss, grads, calls, tokens = res[name]
        errors += _grad_errors(f"{world} {name}", (loss, grads), refs[name])
        # a seq-plan attention runs sharded; nothing else does
        sharded = calls.get("fastmax_sharded", 0) > 0
        if sharded != (arch in SEQ_PLAN):
            errors.append(f"{world} {name}: fastmax_sharded calls "
                          f"{calls.get('fastmax_sharded', 0)}")
        if attn == "hybrid2-kernel":
            # one call a layer on the whole sequence, and remat's recompute
            layers = get_smoke_config(arch).n_layers
            if tokens != [SEQ] * (2 * layers):
                errors.append(f"{world} {name}: hybrid calls' tokens "
                              f"{tokens}")
    if world == 2:
        loss, grads, _, _ = res["model-backward"]
        ref_loss, ref = refs[_name(*MODEL_BACKWARD)]
        mixer = {n: g for n, g in ref.items() if "/mixer/" in f"/{n}/"}
        assert mixer, sorted(ref)
        # the forward is the same; the mixer's grads are whole on both
        # ranks and summed over "seq": 2x (and so not --cp 1's)
        errors += _grad_errors("model-backward", (loss, {
            n: grads[n] for n in mixer}), (ref_loss, mixer), scale=2.0)
        errors += _grad_errors("model-backward", (loss, {
            n: g for n, g in grads.items() if n not in mixer}), (ref_loss, {
                n: g for n, g in ref.items() if n not in mixer}))
        if not _grad_errors("model-backward", (loss, grads),
                            (ref_loss, ref)):
            errors.append("the 'model' split's backward passed")
    assert not errors, "\n".join(errors)


@pytest.mark.parametrize("arch, attn, mixer", [
    ("whisper-small", None, "encoder-decoder")])
def test_cp_refuses_the_other_mixers(arch, attn, mixer):
    """The one refusal: an encoder-decoder model (every decoder mixer
    trains under --cp: `test_cp_takes_fastmax`)."""
    cfg = get_smoke_config(arch)
    if attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(attn))
    with pytest.raises(ValueError, match=f"--cp: .*{mixer}.*--cp 1"):
        check_cp(cfg)


@pytest.mark.parametrize("arch, attn", [
    pytest.param("qwen3-1.7b", a, id=a)
    for a in ("fastmax2-kernel", "fastmax2-chunked", "fastmax1-kernel",
              "softmax", "hybrid2-kernel", "fastmax2-rowwise")] + [
    pytest.param(a, None, id=a)
    for a in ("jamba-v0.1-52b", "xlstm-1.3b", "deepseek-v2-236b",
              "kimi-k2-1t-a32b")])
def test_cp_takes_fastmax(arch, attn):
    """check_cp takes every decoder: Fastmax on its seq plan, the other
    mixers gathered."""
    cfg = get_smoke_config(arch)
    if attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(attn))
    check_cp(cfg)


def test_cp_refusal_comes_before_the_group():
    """No process group is needed to refuse a config."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="encoder-decoder"):
        train.main(ARGV + ["--arch", "whisper-small", "--cp", "2"])
