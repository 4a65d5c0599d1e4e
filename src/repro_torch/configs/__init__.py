"""Per-architecture configs (``--arch <id>``) of the ported LM blocks.

Each module exports CONFIG (the exact assigned configuration, value for
value the reference's) and smoke() (a reduced same-family config for CPU
tests). Only the architectures whose blocks are ported are here; the
reference's other eight wait for theirs (:data:`WAITING`).
"""
import importlib

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-0.6b": "qwen3_0_6b",
}

ARCH_IDS = tuple(_MODULES)

#: the reference's other architectures, with the ROADMAP item each
#: waits for
WAITING = {
    "qwen1.5-4b": "A16 (the other dense configs)",
    "nemotron-4-15b": "A16 (the other dense configs)",
    "stablelm-12b": "A16 (the other dense configs)",
    "chameleon-34b": "A16 (the other dense configs)",
    "granite-moe-3b-a800m": "A17 (MoE)",
    "granite-moe-1b-a400m": "A17 (MoE)",
    "recurrentgemma-9b": "A18 (RG-LRU)",
    "whisper-tiny": "A19 (encoder-decoder)",
}


def _module(arch: str):
    if arch in WAITING:
        raise NotImplementedError(f"{arch} is not ported yet: ROADMAP "
                                  f"{WAITING[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).smoke()

