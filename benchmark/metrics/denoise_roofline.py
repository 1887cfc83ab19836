"""denoise_roofline: K2 and K3 (``csrc/denoise_mlp.cu``, the rebuild's
denoiser forward) as a share of their bound, over the profiled window.

The rebuild runs each modality's denoiser ``steps`` times on every user's
row, in blocks of ``batch`` users: layer 1 a (rows, I) x (I, H) product,
layer 2 a (rows, H) x (H, I) one. A block-step's least time is the larger
of its 4·rows·I·H operations at the TF32 rate (one product per
multiply-add; the kernels run three TF32 products for each, so they cannot
reach 100%) and its bytes at the HBM rate (x, W1, h, W2 and the output,
f32, each once). Only real users' rows count, not a block's padding. The
time is the device time of the kernels' launches (``gemm_3xtf32``,
``strip_3xtf32``, ``splitk_sum``)."""

from benchmark.harness.peaks import HBM_BYTES_S, TF32_FLOPS


def epoch_bound_s(users: int, items: int, hidden: int, batch: int, modalities: int, steps: int) -> float:
    total = 0.0
    for lo in range(0, users, batch):
        rows = min(batch, users - lo)
        ops = 4.0 * rows * items * hidden
        nbytes = 4.0 * (2 * rows * items + 2 * items * hidden + 2 * rows * hidden)
        total += max(ops / TF32_FLOPS, nbytes / HBM_BYTES_S)
    return total * modalities * steps


def read(layer: dict):
    trace, shape = layer.get("trace"), layer.get("shape")
    if trace is None or shape is None or len(shape["hidden"]) != 1:
        return None
    secs, n = trace.kernel_s("gemm_3xtf32", "strip_3xtf32", "splitk_sum")
    if n == 0 or secs <= 0:
        return None
    bound = layer["trace_epochs"] * epoch_bound_s(
        shape["users"], shape["items"], shape["hidden"][0], shape["batch"], len(shape["feat_dims"]), shape["steps"])
    return 100.0 * bound / secs
