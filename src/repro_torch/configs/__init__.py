"""Architecture registry of the port — mirrors `repro.configs`. Only the
architectures whose mixers are ported are listed; the rest come with
their slices."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

# public ids used on the CLI (--arch) mapped to module names
ARCH_IDS = {
    "qwen3-1.7b": "qwen3_1_7b",
    "whisper-small": "whisper_small",
}


def _module(name: str):
    mod = ARCH_IDS.get(name, name)
    if mod not in ARCH_IDS.values():
        raise KeyError(f"architecture {name!r} is not ported yet; "
                       f"ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg

