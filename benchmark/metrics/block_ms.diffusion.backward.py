"""block_ms.diffusion.backward: device ms of one diffusion step's ``backward``,
autograd's backward and the gradients' reduction; the median over the
profiled window's ``diffusion`` spans, each carrying its last block's parts
(``train/steps.py`` ``DIFFUSION_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "diffusion", "backward")
