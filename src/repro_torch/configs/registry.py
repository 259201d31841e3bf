"""Architecture registry: --arch <id> -> ModelConfig."""
from importlib import import_module
from typing import Dict

from .base import ModelConfig

_MODULES = {
    "llama-3.2-vision-11b": ".llama_3_2_vision_11b",
    "whisper-small": ".whisper_small",
    "qwen1.5-110b": ".qwen1_5_110b",
    "qwen2.5-32b": ".qwen2_5_32b",
    "granite-8b": ".granite_8b",
    "h2o-danube-1.8b": ".h2o_danube_1_8b",
    "mamba2-370m": ".mamba2_370m",
    "zamba2-1.2b": ".zamba2_1_2b",
    "mixtral-8x22b": ".mixtral_8x22b",
    "grok-1-314b": ".grok_1_314b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return import_module(_MODULES[arch], package=__package__).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
