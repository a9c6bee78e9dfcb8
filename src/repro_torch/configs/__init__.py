"""Architecture registry of the port — mirrors `repro.configs`: all ten of
the reference's architectures (attention with an MLP or MoE ffn, MLA,
encoder-decoder, and since the SSM slice jamba-v0.1-52b's Mamba and
attention mixers and xlstm-1.3b's mLSTM and sLSTM), and the reference's
table of shapes (`SHAPES`), which the dry run (`launch/dryrun.py`) reads."""
from __future__ import annotations

import dataclasses
import importlib
from typing import NamedTuple

from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCH_NAMES", "ARCH_IDS", "ShapeSpec", "SHAPES", "get_config",
           "get_smoke_config", "all_arch_ids"]

ARCH_NAMES = [
    "qwen2_5_32b",
    "granite_20b",
    "qwen3_1_7b",
    "llama3_405b",
    "whisper_small",
    "deepseek_v2_236b",
    "kimi_k2_1t",
    "chameleon_34b",
    "xlstm_1_3b",
    "jamba_52b",
]

# public ids used on the CLI (--arch) mapped to module names
ARCH_IDS = {
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-20b": "granite_20b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3-405b": "llama3_405b",
    "whisper-small": "whisper_small",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "chameleon-34b": "chameleon_34b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-v0.1-52b": "jamba_52b",
}


class ShapeSpec(NamedTuple):
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec(4096, 256, "train"),
    "prefill_32k": ShapeSpec(32768, 32, "prefill"),
    "decode_32k": ShapeSpec(32768, 128, "decode"),
    "long_500k": ShapeSpec(524288, 1, "decode"),
    # context-parallel training: 1M tokens across a "seq" mesh axis
    # (dryrun --cp; each rank's step sees seq_len / cp tokens)
    "train_1M": ShapeSpec(1048576, 16, "train"),
}


def _module(name: str):
    mod = ARCH_IDS.get(name, name)
    if mod not in ARCH_IDS.values():
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_arch_ids():
    return list(ARCH_IDS.keys())
