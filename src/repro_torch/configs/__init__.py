"""Assigned architecture configs (exact published dims) + registry.

The same data as the reference package's ``configs``, kept as this
package's own copy so that it imports nothing of the reference."""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.jamba_v01_52b import CONFIG as JAMBA
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM
from repro_torch.configs.qwen2_72b import CONFIG as QWEN2
from repro_torch.configs.starcoder2_7b import CONFIG as STARCODER2
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS
from repro_torch.configs.phi35_moe_42b import CONFIG as PHI35
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK
from repro_torch.configs.llava_next_34b import CONFIG as LLAVA

ARCHS = {
    c.name: c
    for c in [JAMBA, XLSTM, QWEN3, MINICPM, QWEN2, STARCODER2, SEAMLESS,
              PHI35, DEEPSEEK, LLAVA]
}

# CLI-friendly aliases (--arch <id> from the assignment table)
ALIASES = {
    "jamba-v0.1-52b": "jamba-v0.1-52b",
    "xlstm-1.3b": "xlstm-1.3b",
    "qwen3-14b": "qwen3-14b",
    "minicpm-2b": "minicpm-2b",
    "qwen2-72b": "qwen2-72b",
    "starcoder2-7b": "starcoder2-7b",
    "seamless-m4t-medium": "seamless-m4t-medium",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "deepseek-v3-671b": "deepseek-v3-671b",
    "llava-next-34b": "llava-next-34b",
}


def get_config(name: str) -> ArchConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


__all__ = ["ArchConfig", "ARCHS", "get_config"]
