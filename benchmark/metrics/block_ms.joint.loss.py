"""block_ms.joint.loss: device ms of one joint step's ``loss``, the losses:
BPR, L2 and both contrastive terms with their gathers and propagations; the
median over the profiled window's ``joint`` spans, each carrying its last
block's parts (``train/steps.py`` ``JOINT_PARTS``)."""

from benchmark.harness.spans import part_ms


def read(layer: dict):
    return part_ms(layer, "joint", "loss")
