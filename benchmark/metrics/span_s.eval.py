"""span_s.eval: device seconds of one eval (the GCN forward over the
rebuilt graphs and the full-catalog ranking of the test users), the median
over the profiled window's ``eval`` spans."""

from benchmark.harness.spans import median_of, window_records


def read(layer: dict):
    records = window_records(layer)
    if records is None:
        return None
    return median_of([r["device_s"] for r in records if r["name"] == "eval"])
