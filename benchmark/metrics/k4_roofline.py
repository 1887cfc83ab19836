"""k4_roofline: K4 (``csrc/segsum.cu``, the sparse form's propagation and
every loss gather's backward) as a share of its bound, over the profiled
window.

The program counts, at each launch, the least bytes of the function the
launch computes (``ops/kernels/segsum.py::least_bytes``: the table rows the
edges can name, the index vectors, the offsets and the f32 output, each
once), through graph replays too; the bytes of the window are those counted
in its top-level spans. Their time at the card's HBM rate over the device
time of the trace's K4 activity (``segsum_plan`` and ``segsum_kernel``, the
two launches of a call) is the share."""

from benchmark.harness.peaks import HBM_BYTES_S
from benchmark.harness.spans import top_level, window_records


def read(layer: dict):
    records = window_records(layer)
    if records is None:
        return None
    n_bytes = sum(r["work"].get(k, 0) for r in top_level(records)
                  for k in ("segsum.bytes", "segsum_unfused.bytes"))
    secs, n = layer["trace"].kernel_s("segsum_")
    if n_bytes <= 0 or n == 0 or secs <= 0:
        return None
    return 100.0 * (n_bytes / HBM_BYTES_S) / secs
