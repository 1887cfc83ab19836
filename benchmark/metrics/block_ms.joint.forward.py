"""block_ms.joint.forward: device ms of one joint step's ``forward``, the GCN
forward: the loss gathers' plans and the propagations (gcn_mm); the median
over the profiled window's ``joint`` spans, each carrying its last block's
parts (``train/steps.py`` ``JOINT_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "joint", "forward")
