"""block_ms.joint.adam: device ms of one joint step's ``adam``, the Adam update
of the GCN parameters and the accumulator's add; the median over the
profiled window's ``joint`` spans, each carrying its last block's parts
(``train/steps.py`` ``JOINT_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "joint", "adam")
