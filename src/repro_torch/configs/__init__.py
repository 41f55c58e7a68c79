"""Architecture registry: ``get_config(name, smoke=)`` as in ``repro/configs``.

The port carries the configs whose blocks it implements: the dense decoders
TinyLlama-1.1B, Qwen3-4B, Qwen3-14B and Command-R-35B, the MoE decoders
Phi-3.5-MoE and DeepSeek-V3 (MLA, MTP), the recurrent xLSTM-125m, the hybrid
Jamba-1.5-Large (Mamba, attention, MoE), the cross-attention families
Llama-3.2-Vision-11B (gated image layers) and Whisper-large-v3 (encoder-
decoder), and the paper's own models: every config the reference registers.
Each module is a data-only copy of the reference's.  ``get_config(id)``
returns the exact full-size config; ``get_config(id, smoke=True)`` a reduced
same-family config for CPU tests.
"""
from __future__ import annotations

from typing import List

from repro_torch.config import ModelConfig
from repro_torch.configs import (command_r_35b, deepseek_v3_671b, jamba_1_5_large_398b,
                                 llama32_vision_11b, paper_models, phi35_moe_42b, qwen3_4b,
                                 qwen3_14b, tinyllama_1_1b, whisper_large_v3, xlstm_125m)

_MODULES = {
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "qwen3-4b": qwen3_4b,
    "qwen3-14b": qwen3_14b,
    "command-r-35b": command_r_35b,
    "xlstm-125m": xlstm_125m,
    "deepseek-v3-671b": deepseek_v3_671b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "whisper-large-v3": whisper_large_v3,
}

# the ten assigned architectures, in the reference's order (the dry run's cells)
ASSIGNED: List[str] = ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "tinyllama-1.1b", "qwen3-4b",
                       "qwen3-14b", "command-r-35b", "jamba-1.5-large-398b", "xlstm-125m",
                       "llama-3.2-vision-11b", "whisper-large-v3"]

# architectures with sub-quadratic sequence mixing: the only ones that run
# the long_500k cell
LONG_CONTEXT_CAPABLE = ("jamba-1.5-large-398b", "xlstm-125m")

PAPER_CONFIGS = {
    "bert-base": paper_models.BERT_BASE,
    "bert-large": paper_models.BERT_LARGE,
    "gpt-base": paper_models.GPT_BASE,
    "deit-b": paper_models.DEIT_B,
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in _MODULES:
        return _MODULES[name].smoke() if smoke else _MODULES[name].FULL
    if name in PAPER_CONFIGS:
        return PAPER_CONFIGS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES) + sorted(PAPER_CONFIGS)}")


def cell_is_skipped(arch: str, shape_name: str) -> str:
    """A reason string if the dry run skips (arch, shape), else ''."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_CAPABLE:
        return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return ""
