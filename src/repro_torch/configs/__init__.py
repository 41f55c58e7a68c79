"""Architecture registry: ``get_config(name, smoke=)`` as in ``repro/configs``.

The port carries the configs its serving path runs (TinyLlama-1.1B) and the
paper's own models.  ``get_config(id)`` returns the exact full-size config;
``get_config(id, smoke=True)`` a reduced same-family config for CPU tests.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs import paper_models, tinyllama_1_1b

_MODULES = {
    "tinyllama-1.1b": tinyllama_1_1b,
}

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
