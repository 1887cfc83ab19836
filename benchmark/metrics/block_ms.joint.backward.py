"""block_ms.joint.backward: device ms of one joint step's ``backward``,
autograd's backward of the step's loss and the gradients' reduction; the
median over the profiled window's ``joint`` spans, each carrying its last
block's parts (``train/steps.py`` ``JOINT_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "joint", "backward")
