"""The reference's four examples on the port, as modules of the package:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.vcycle_pretrain [--config moe] [--full-100m]
    python -m repro_torch.examples.serve_decode [--policy speculative]
    python -m repro_torch.examples.elastic_restart

Each keeps the reference's flags, defaults, configs and printed lines, adds
``--device`` (default: the CUDA card, which must be present), and has a
``main(argv=None)`` that returns what it printed as a dict.
"""
from __future__ import annotations

from typing import Dict, List


class Printer:
    """``say(text)`` prints a line and keeps it; ``out`` is the dict a
    ``main`` returns: the values it printed under their names, and every
    printed line under ``"lines"``."""

    def __init__(self):
        self.lines: List[str] = []
        self.out: Dict = {"lines": self.lines}

    def say(self, text: str = "") -> None:
        print(text, flush=True)
        self.lines.append(text)
