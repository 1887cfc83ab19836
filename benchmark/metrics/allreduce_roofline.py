"""allreduce_roofline: the mesh's all-reduces as a share of their bound,
over the profiled window of rank 0's card.

The program counts, at each all-reduce, the bytes of the buffer it sums
(``parallel/collectives.py``: ``allreduce.<site>.bytes`` by the site that
asks for it, through graph replays too); the bytes of the window are those
counted in its top-level spans. Each card has to receive at least a
buffer's bytes for any all-reduce of it (with the reduction in the switch,
NVLink SHARP, it receives exactly that), so the bound is the bytes at one
direction of the card's NVLink: 450 GB/s, half of the 900 GB/s total of
an H100 SXM's NVLink 4 (NVIDIA's data sheet). Its share of the device time
of the NCCL all-reduce kernels in the trace (their union: a kernel that
waits for a later card counts its wait) is the share."""

from benchmark.harness.spans import top_level, window_records
from benchmark.harness.trace import TraceSummary

NVLINK_BYTES_S = 450e9


def allreduce_bytes(records: list[dict]) -> int:
    """The all-reduces' bytes counted in ``records``' top-level spans."""
    return sum(n for r in top_level(records) for k, n in r["work"].items()
               if k.startswith("allreduce.") and k.endswith(".bytes"))


def read(layer: dict):
    records = window_records(layer)
    if records is None:
        return None
    n_bytes = allreduce_bytes(records)
    trace = layer["trace"]
    kernels = [ev for ev in trace.device if "nccl" in ev[0] and "AllReduce" in ev[0]]
    secs = TraceSummary(trace.window_s, kernels, []).busy_s
    if n_bytes <= 0 or secs <= 0:
        return None
    return 100.0 * (n_bytes / NVLINK_BYTES_S) / secs
