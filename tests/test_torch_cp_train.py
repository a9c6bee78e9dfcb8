"""Context-parallel training (`launch/train.py --cp`, `launch/steps.py`)
on gloo worlds of 2 and 4 ranks, the smoke qwen3 on fastmax2-kernel (the
kernels' plain versions on the CPU): `--cp 2` on two ranks, and on a
(data 2, seq 2) mesh of four, equals `--cp 1` in one process, losses and
per-leaf grads at float32 limits, and a checkpoint resumes across
`--cp 2` and `--cp 1` both ways. The `--cp` argument errors and the
refusal of the mixers that need the whole sequence on one rank.

The reference lets GSPMD gather those mixers' sequence instead
(ROADMAP queue 3, recorded divergences)."""
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


@pytest.mark.parametrize("arch, attn, mixer", [
    ("qwen3-1.7b", "softmax", "softmax attention backend"),
    ("qwen3-1.7b", "hybrid2-kernel", "hybrid-kernel attention backend"),
    ("qwen3-1.7b", "fastmax2-rowwise", "fastmax-rowwise attention backend"),
    ("jamba-v0.1-52b", None, "mamba mixer"),
    ("xlstm-1.3b", None, "mlstm mixer"),
    ("deepseek-v2-236b", None, "MoE layers"),
    ("kimi-k2-1t-a32b", None, "MoE layers"),
    ("whisper-small", None, "encoder-decoder"),
])
def test_cp_refuses_the_other_mixers(arch, attn, mixer):
    cfg = get_smoke_config(arch)
    if attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(attn))
    with pytest.raises(ValueError, match=f"--cp: .*{mixer}.*--cp 1"):
        check_cp(cfg)


@pytest.mark.parametrize("attn", ["fastmax2-kernel", "fastmax2-chunked",
                                  "fastmax1-kernel"])
def test_cp_takes_fastmax(attn):
    check_cp(dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                 attn=AttentionSpec.parse(attn)))


def test_cp_refusal_comes_before_the_group():
    """No process group is needed to refuse a mixer."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="softmax"):
        train.main([*ARGV[:4], "softmax", *ARGV[5:], "--cp", "2"])
