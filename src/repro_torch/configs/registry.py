"""Architecture registry: ``--arch <id>`` resolution for the six families
the port runs (dense, moe, hybrid, vlm, ssm, audio); dbrx-132b is
registered as a config only (132B parameters fit no single card)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "starcoder2-7b":      "repro_torch.configs.starcoder2_7b",
    "qwen2-72b":          "repro_torch.configs.qwen2_72b",
    "qwen2-0.5b":         "repro_torch.configs.qwen2_0_5b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "dbrx-132b":          "repro_torch.configs.dbrx_132b",
    "recurrentgemma-2b":  "repro_torch.configs.recurrentgemma_2b",
    "internvl2-2b":       "repro_torch.configs.internvl2_2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "xlstm-125m":         "repro_torch.configs.xlstm_125m",
    "paper-testapp":      "repro_torch.configs.paper_testapp",
}


# every arch but the paper's test app (the reference's list)
ASSIGNED_ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "paper-testapp"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown or not yet ported arch {arch!r}; available: "
            f"{', '.join(sorted(_ARCH_MODULES))}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)
