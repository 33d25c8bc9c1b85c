"""The card a run measures: its presence, name, power limit and clocks."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict

import torch


class NoCard(RuntimeError):
    pass


def require(chips: int) -> None:
    """Raise ``NoCard`` unless PyTorch sees ``chips`` CUDA devices."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark measures the card and "
                     "runs nowhere else")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, {have} present")


def open_contexts(chips: int) -> None:
    """Make each card's CUDA context (the process's first work there)."""
    for i in range(chips):
        torch.empty(1, device=f"cuda:{i}")
    torch.cuda.synchronize()


def smi(query: str, index: int = 0) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def describe(index: int = 0) -> Dict[str, str]:
    """The card's name and power limit, and its SM and memory clocks now
    (an idle card clocks down, so read this next to the work)."""
    name, limit, sm, mem = (v.strip() for v in smi(
        "name,power.limit,clocks.sm,clocks.mem", index).split(","))
    return {"name": name, "power_limit": limit, "sm_clock": sm,
            "mem_clock": mem}


def print_card(label: str, index: int = 0) -> None:
    d = describe(index)
    line = (f"card {label}: {d['name']}, power.limit {d['power_limit']}, "
            f"clocks.sm {d['sm_clock']}, clocks.mem {d['mem_clock']}")
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
