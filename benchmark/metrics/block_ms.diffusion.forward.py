"""block_ms.diffusion.forward: device ms of one diffusion step's ``forward``,
the rows' gather, the noise, every modality's denoiser forward and loss; the
median over the profiled window's ``diffusion`` spans, each carrying its
last block's parts (``train/steps.py`` ``DIFFUSION_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "diffusion", "forward")
