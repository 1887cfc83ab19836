"""serve.host_ms_per_req: milliseconds from the call of ``recommend`` to its
ids and scores on the host, the queue's wait excluded: the median over the
traced window's requests."""

from statistics import median


def read(layer: dict):
    service = layer.get("service_s")
    if layer.get("kind") != "serve" or service is None or len(service) == 0:
        return None
    return 1e3 * median(service)
