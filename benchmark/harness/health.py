"""What a run says about its card and itself on earlier lines of standard
error: the card's name, power limit, clocks and temperature beside the
window, the memory peak, and the run's own health readings."""

from __future__ import annotations

import json
import subprocess
import sys

_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"


def smi(index: int = 0) -> str:
    """One ``nvidia-smi`` reading of the card, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), f"--query-gpu={_QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def note(what: str, **values) -> None:
    """One ``health`` line on standard error."""
    print(f"health {what}: {json.dumps(values, default=str)}", file=sys.stderr, flush=True)
