"""phase_s.diffusion: seconds of the epoch's ``diffusion`` phase, on ``Coach.timer``
with ``fence=True`` (the phase ends when the card is done), the median
over the fenced epochs that follow a traced run's profiled steps."""

from statistics import median


def read(layer: dict):
    values = layer.get("phases", {}).get("diffusion")
    return median(values) if values else None
