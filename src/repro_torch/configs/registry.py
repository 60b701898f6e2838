"""Architecture registry: ``--arch <id>`` resolution for the dense family,
the part of the reference's registry that the port can run."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "starcoder2-7b":      "repro_torch.configs.starcoder2_7b",
    "qwen2-72b":          "repro_torch.configs.qwen2_72b",
    "qwen2-0.5b":         "repro_torch.configs.qwen2_0_5b",
    "paper-testapp":      "repro_torch.configs.paper_testapp",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown or not yet ported arch {arch!r}; available: "
            f"{', '.join(sorted(_ARCH_MODULES))}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)
