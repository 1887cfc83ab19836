"""Checkpoints of the full training state, written with ``torch.save``.

Counterpart of ``diffmm_tpu/utils/checkpoint.py:28-117`` (orbax there):
one file per saved epoch, ``ckpt_<epoch>.pt`` under the directory, holding
the tensors (host copies) and a JSON-able dict beside them (the epoch, the
best-metric tracking, the numpy stream's state, the Adam counts). The
torch generator's ``get_state()`` rides with the tensors in place of the
JAX key. The newest ``max_to_keep`` files are kept. A save writes a
temporary file and renames it, so a run that stops mid-save leaves the
previous checkpoints whole.

Saves are synchronous: the JAX package's ``async_save`` overlaps orbax's
disk write with training, and has no counterpart here (``wait`` and
``close`` have nothing to wait for).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def to_host(tree):
    """``tree`` (dicts and lists of tensors) with every tensor copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree


class CheckpointManager:
    """Numbered checkpoints in ``directory`` (made if missing)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch:08d}.pt")

    def epochs(self) -> list[int]:
        """The saved epochs, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, arrays: Any, aux: dict[str, Any]) -> None:
        """``arrays``: dicts and lists of tensors (copied to the host);
        ``aux``: JSON-serialisable."""
        path = self._path(epoch)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"arrays": to_host(arrays), "aux": json.dumps(aux)}, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> int | None:
        saved = self.epochs()
        return saved[-1] if saved else None

    def restore(self, epoch: int | None = None):
        """``(epoch, arrays, aux)`` of ``epoch`` (default: the latest), the
        tensors on the host."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        blob = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        return epoch, blob["arrays"], json.loads(blob["aux"])

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing stays open between saves."""


def rng_state_to_json(rng: np.random.Generator) -> str:
    """Serialise a numpy Generator's bit-generator state."""
    return json.dumps(rng.bit_generator.state)


def rng_state_from_json(state: str) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = json.loads(state)
    return rng
