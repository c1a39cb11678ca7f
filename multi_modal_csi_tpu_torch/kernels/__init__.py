"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper counts its launches in ``LAUNCH_COUNTS`` (kernel name -> number
of launches since the last ``reset_launch_counts()``), adding one only where
it launches its CUDA kernel, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

from typing import Dict

LAUNCH_COUNTS: Dict[str, int] = {}


def count_launch(name: str) -> None:
    LAUNCH_COUNTS[name] = LAUNCH_COUNTS.get(name, 0) + 1


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
