"""mfu.train_mesh: the whole training epoch's share of the peak of every
card of the mesh: the operations one epoch needs, counted as
``mfu.train.py`` counts them (its ``epoch_flops``), over the cards
(``layer["cards"]``) times ``train_epoch_s`` times the TF32 rate. On one
card it is ``mfu.train``."""

import importlib.util
import os

from benchmark.harness.peaks import TF32_FLOPS

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_mfu.train", os.path.join(os.path.dirname(os.path.abspath(__file__)), "mfu.train.py"))
_mfu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mfu)


def read(layer: dict):
    shape, epoch_s, cards = layer.get("shape"), layer.get("train_epoch_s"), layer.get("cards")
    if layer.get("kind") != "train" or shape is None or not epoch_s or not cards:
        return None
    return 100.0 * _mfu.epoch_flops(shape) / (cards * epoch_s * TF32_FLOPS)
