"""block_ms.diffusion.reduce: device ms of one diffusion step's ``reduce``,
the denoisers' gradients summed over the mesh (one all-reduce of one flat
buffer, with its copy in and out), recorded on a mesh only; the median
over the profiled window's ``diffusion`` spans, each carrying its last
block's parts (``train/steps.py`` ``MESH_DIFFUSION_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "diffusion", "reduce")
