"""Per-architecture configs (``--arch <id>``) of the LM substrate.

Each module exports CONFIG (the exact assigned configuration, value for
value the reference's) and smoke() (a reduced same-family config for CPU
tests), for all ten of the reference's architectures, in its order.
``paper_gpu`` (the paper's simulated GPU) and ``shapes`` (the assigned
input shapes) are the reference's two other config modules.
"""
import importlib
from typing import Dict

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen1.5-4b": "qwen1_5_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "stablelm-12b": "stablelm_12b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "chameleon-34b": "chameleon_34b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke()


def all_configs() -> Dict[str, object]:
    return {a: get_config(a) for a in ARCH_IDS}
