"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card, a call that did not ask for the CPU raises: no entry point falls back
to the CPU on its own.
"""

from __future__ import annotations

import torch

# One H100 SXM's HBM3 rate, the published peak: the measuring programs'
# bound of a pass that reads memory
HBM_BYTES_S = 3.35e12


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    one); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "diffmm_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (the measuring programs' fence, where
    the JAX package calls ``jax.block_until_ready``); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (a card below its full power limit runs slower under load), or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()
