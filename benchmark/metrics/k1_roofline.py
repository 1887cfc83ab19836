"""k1_roofline: K1 (``csrc/spmm_dual.cu``, the dense form's propagation) as
a share of its bound, over the profiled window.

Each launch propagates over one (U, I) block: its least time reads the
block's cells once, reads z (f32, U + I rows of d) once and writes y (f32)
once, at the card's HBM rate (its operations, 2·U·I·d at the bf16 rate, take
less). The bound of the window is the launches the trace shows (kernel
``dual_kernel``) times that; the time is their device time."""

from benchmark.harness.peaks import HBM_BYTES_S

CELL_BYTES = {"int8": 1.0, "bf16": 2.0, "int4": 0.5}


def launch_bytes(users: int, items: int, d: int, store: str) -> float:
    return users * items * CELL_BYTES[store] + 2 * 4 * (users + items) * d


def read(layer: dict):
    trace, shape = layer.get("trace"), layer.get("shape")
    if trace is None or shape is None or shape["graph_form"] != "dense":
        return None
    secs, n = trace.kernel_s("dual_kernel")
    if n == 0 or secs <= 0:
        return None
    bound = n * launch_bytes(shape["users"], shape["items"], shape["latdim"], shape["dense_store"]) / HBM_BYTES_S
    return 100.0 * bound / secs
