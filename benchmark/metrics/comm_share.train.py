"""comm_share.train: the share of rank 0's busy device time in the profiled
window of a train cell that NCCL's kernels take: 100 x the union of their
activity intervals over the union of every activity's (``busy_s``). A
mesh's collectives that neither overlap other work nor shrink show here."""

from benchmark.harness.trace import TraceSummary


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("kind") != "train" or trace is None or trace.busy_s <= 0:
        return None
    nccl = TraceSummary(trace.window_s, [ev for ev in trace.device if "nccl" in ev[0]], []).busy_s
    if nccl <= 0:
        return None
    return 100.0 * nccl / trace.busy_s
