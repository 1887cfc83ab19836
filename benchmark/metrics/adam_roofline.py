"""adam_roofline: Adam's one pass (``csrc/adam.cu``: every f32 tree's update
in the diffusion and joint steps) as a share of its bound, over the profiled
window.

The program counts, at each launch, the least bytes of the step it computes
(``ops/kernels/adam.py::least_bytes``: 28 a parameter, p, the gradient and
both moments read once, p and both moments written once), through graph
replays too; the bytes of the window are those counted in its top-level
spans. Their time at the card's HBM rate over the device time of the trace's
``adam_kernel`` activity is the share. A program without the counter (one
older than the pass, whose Adam ran as ``_foreach`` passes) reads None."""

from benchmark.harness.peaks import HBM_BYTES_S
from benchmark.harness.spans import top_level, window_records


def read(layer: dict):
    records = window_records(layer)
    if records is None:
        return None
    n_bytes = sum(r["work"].get("adam.bytes", 0) for r in top_level(records))
    secs, n = layer["trace"].kernel_s("adam_kernel")
    if n_bytes <= 0 or n == 0 or secs <= 0:
        return None
    return 100.0 * (n_bytes / HBM_BYTES_S) / secs
