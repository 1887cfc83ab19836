"""block_ms.diffusion.adam: device ms of one diffusion step's ``adam``, every
denoiser's Adam update and the loss accumulator's update; the median over
the profiled window's ``diffusion`` spans, each carrying its last block's
parts (``train/steps.py`` ``DIFFUSION_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "diffusion", "adam")
