"""Config registry of the ported architectures.

``get_config(name)``   — the published config.
``smoke_config(name)`` — same family, reduced dims (CPU tests).
``SHAPES``             — the assigned input-shape set (per-arch cells).

Architectures of the reference that are not ported yet raise and name
their ROADMAP item.
"""
from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

#: the dense family: qwen3-1.7b, and granite-3-8b, phi4-mini-3.8b and
#: glm4-9b (the reference's own configs, copied field for field)
ARCH_IDS = ["qwen3-1.7b", "granite-3-8b", "phi4-mini-3.8b", "glm4-9b"]

# assigned input-shape set (LM-family): seq_len x global_batch
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

#: the reference's other architectures -> the ROADMAP item that ports them
PENDING = {
    "qwen3-moe-235b-a22b": "A16c",
    "qwen3-moe-30b-a3b": "A16c",
    "mamba2-1.3b": "A16d",
    "zamba2-7b": "A16e",
    "seamless-m4t-large-v2": "A16f",
    "internvl2-76b": "A16g",
}


def _module(name: str):
    if name not in ARCH_IDS:
        if name in PENDING:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                      f"{PENDING[name]})")
        raise ValueError(f"unknown architecture {name!r}; ported: "
                         f"{ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
