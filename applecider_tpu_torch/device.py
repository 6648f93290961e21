"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it (``device="cpu"``), as the tests do. Asking for CUDA
on a machine without a usable GPU raises instead of falling back.
"""

from __future__ import annotations

import subprocess

import torch


def card_name_and_power() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``); written beside every
    number measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    ``None`` and ``"cuda"`` mean the current CUDA device; ``"cpu"`` is the
    explicit opt-in to the plain CPU path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
