"""The program's span records in a traced run's profiled window, for the
per-layer metrics that read them (``k4_roofline``, ``span_s.eval``,
``block_ms.*``).

The program keeps its last span records in memory
(``diffmm_tpu_torch.utils.profiling.span_records``): a name, the parent
span's name, host enter and exit stamps on the profiler's clock
(``time.time_ns()``), device seconds, the kernels' work counted over the
span, and the parts of the last captured step a phase ran. The window's
records are those whose host enter stamp lies between the first and the
last host event of the trace. A program without span records (one older
than them) gives None, and so does a run without a trace.
"""

from __future__ import annotations

from statistics import median


def window_records(layer: dict) -> list[dict] | None:
    """The profiled window's span records, or None."""
    trace = layer.get("trace")
    if trace is None or not trace.host:
        return None
    try:
        from diffmm_tpu_torch.utils.profiling import span_records
    except ImportError:
        return None
    lo = min(s for _, s, _ in trace.host)
    hi = max(e for _, _, e in trace.host)
    records = [r for r in span_records() if lo <= r["enter_ns"] <= hi]
    return records or None


def top_level(records: list[dict]) -> list[dict]:
    """The records of spans that no other span holds (they do not overlap,
    so counters summed over them count each launch once)."""
    return [r for r in records if r["parent"] is None]


def median_of(values: list[float]):
    values = [v for v in values if v is not None and v > 0]
    return median(values) if values else None


def part_ms(layer: dict, phase: str, part: str):
    """Device ms of ``part`` of one block of ``phase``: the median over the
    window's ``phase`` spans that carry their last block's parts."""
    records = window_records(layer)
    if records is None:
        return None
    return median_of([1e3 * r["parts"][part] for r in records
                      if r["name"] == phase and r["parts"] and part in r["parts"]])
