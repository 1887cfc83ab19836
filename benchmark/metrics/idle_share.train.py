"""idle_share.train: the share of the profiled window of a train cell in which
no operation ran on the card: 100 x (1 - busy / window), busy the union of
the device's activity intervals in the trace, window the host clock's."""


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("kind") != "train" or trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
