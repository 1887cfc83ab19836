"""The training phases' per-block steps as captured CUDA graphs.

Counterpart of the JAX package's compiled phase programs: its diffusion,
rebuild and joint phases are each one jitted program that scans the
phase's blocks (``diffmm_tpu/train/steps.py:210-260, 296-372, 462-484``).
On the card the counterpart of a compiled program is a captured CUDA
graph: a step's hundreds of launches (a joint step's forward, losses,
autograd backward and Adam update) are captured once and replayed for every
block, one host call a block.

:class:`BlockGraph` runs one step function. Its first call runs the step
eagerly on the real first block, on the capture stream (so cuBLAS handles,
the kernels' workspaces and the autograd engine are set up before and
outside the capture); then it captures the step once over copies of the
inputs (the graph's static slots). Every later call copies its block's
inputs into the slots on the card and replays. A step returns nothing: it
writes its results into tensors that outlive it (parameters, Adam moments,
accumulators, tables).

What a step reads besides its inputs stays at the address it had at
capture: the Coach updates its parameters, Adam moments and adjacencies in
place, the phases keep what they compute per epoch (projected features,
prepared denoiser weights, accumulators, top-k tables) in buffers of
:class:`GraphCache` (``hold``, ``buffer``), and the Coach drops its graphs
(``clear``) where it replaces such a tensor. Host numbers a graph would
bake in are either device inputs (the learning rate and Adam's bias
corrections, ``train/optim.py``) or part of the graph's key (the
hyperparameters, the widths), so a changed value captures a new graph.

Random draws come from the Coach's ``torch.Generator``, registered with
each graph (``CUDAGraph.register_generator_state``): a replay reads the
generator's seed and offset as it starts and advances the offset by what
the captured step draws, so it draws what the eager step draws from the
same state, and the generator ends where the eager steps leave it.

Work counts: a kernel wrapper counts its launches (and K4 its bytes,
``ops/kernels``) where its Python code runs, which is once at capture and
never at replay. The capture's counts are taken back and kept as the
graph's work a replay; each replay adds them. Captures and replays are
counted by the key's phase (``utils/profiling.py`` ``GRAPHS``), and a
graph's first eager run and its capture are one ``capture`` span, a child
of its phase's.

A capture that fails raises; nothing falls back to eager on the card.
Each capture first collects Python's cyclic garbage: a dropped graph that
the collector freed during a capture would end it. On the CPU there is no
graph: every call runs the step.

On a mesh the steps hold their collectives (the gradient all-reduce, K4's
mesh forms, the diffusion losses' sum). NCCL's are captured with the rest
of the step, in the ``thread_local`` capture mode (the group's watchdog
thread may query the events of earlier collectives while a capture runs,
which the default ``global`` mode would refuse). Gloo's cannot be
captured: a Coach on a gloo group makes its cache with ``capture=False``,
decided from the backend when the Coach is built, and its steps run
eagerly on the card too.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from diffmm_tpu_torch.ops.kernels import add_work, work_counts
from diffmm_tpu_torch.utils.profiling import GRAPHS, span


class BlockGraph:
    """One step function, run eagerly once, then captured and replayed."""

    def __init__(self, step: Callable[..., None], generator: torch.Generator, stream,
                 error_mode: str = "global", phase: str = "step"):
        self.step = step
        self.phase = phase
        self.generator = generator
        self.stream = stream
        self.error_mode = error_mode
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: tuple[torch.Tensor, ...] = ()
        self.work: dict[str, int] = {}  # kernel work counts a replay (ops/kernels work_counts)
        self.replays = 0

    def __call__(self, *inputs: torch.Tensor) -> None:
        if self.graph is None:
            self._run_and_capture(inputs)
            return
        for slot, x in zip(self.inputs, inputs):
            slot.copy_(x)
        self.graph.replay()
        add_work(self.work)
        self.replays += 1
        GRAPHS[f"{self.phase}.replays"] += 1

    @property
    def launches(self) -> dict[str, int]:
        """Kernel launches a replay."""
        return {k: n for k, n in self.work.items() if "." not in k}

    def _run_and_capture(self, inputs) -> None:
        with span("capture", self.stream.device):
            self._capture(inputs)
        GRAPHS[f"{self.phase}.captures"] += 1

    def _capture(self, inputs) -> None:
        main = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.step(*inputs)
            self.inputs = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        # what is garbage already goes now: a dropped graph (a reset or a
        # discarded Coach's, in a reference cycle) that the collector freed
        # inside the capture would end it, as CUDA refuses to destroy a graph
        # while a stream captures
        gc.collect()
        before = work_counts()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode=self.error_mode):
            self.step(*self.inputs)
        after = work_counts()
        self.work = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_work({k: -v for k, v in self.work.items()})
        main.wait_stream(self.stream)
        self.graph = graph


class GraphCache:
    """A Coach's captured steps, by key, and the buffers they read.

    ``run(key, step, *inputs)`` runs ``step`` on the inputs: on the CPU
    directly, on the card through the :class:`BlockGraph` of ``key`` (made
    with this ``step`` at the key's first call; later calls' steps are not
    read). The key names everything the captured step bakes in besides the
    Coach's state: the phase, its widths, its hyperparameters.

    ``capture=False`` runs every step eagerly on the card as well (a gloo
    group's collectives cannot be captured); ``error_mode`` is the
    captures' ``capture_error_mode`` (``"thread_local"`` where the steps
    hold NCCL collectives)."""

    def __init__(self, device: torch.device, generator: torch.Generator, capture: bool = True,
                 error_mode: str = "global"):
        self.device = device
        self.generator = generator
        self.capture = capture
        self.error_mode = error_mode
        self.graphs: dict[tuple, BlockGraph] = {}
        self._buffers: dict[tuple, torch.Tensor] = {}
        self._stream = None

    def run(self, key: tuple, step: Callable[..., None], *inputs: torch.Tensor) -> None:
        if self.device.type != "cuda" or not self.capture:
            step(*inputs)
            return
        graph = self.graphs.get(key)
        if graph is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            graph = self.graphs[key] = BlockGraph(step, self.generator, self._stream, self.error_mode,
                                                  key[0])
        graph(*inputs)

    def buffer(self, key: tuple, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised tensor: on the card the same one at every call
        for ``key`` (a graph captured over it reads what is written there
        later), a new one on the CPU."""
        shape = tuple(shape)
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype, device=self.device)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(shape, dtype=dtype, device=self.device)
        elif tuple(buf.shape) != shape or buf.dtype != dtype:
            raise ValueError(f"buffer {key}: {tuple(buf.shape)} {buf.dtype}, asked {shape} {dtype}")
        return buf

    def hold(self, key: tuple, value: torch.Tensor) -> torch.Tensor:
        """``value`` copied into the buffer of ``key`` on the card; ``value``
        itself on the CPU."""
        if self.device.type != "cuda":
            return value
        return self.buffer(key, value.shape, value.dtype).copy_(value)

    def find(self, phase: str) -> list[BlockGraph]:
        """The graphs whose key starts with ``phase``, in capture order."""
        return [g for key, g in self.graphs.items() if key[0] == phase]

    def clear(self) -> None:
        """Drop every graph and buffer (the next call of each key captures
        anew)."""
        self.graphs.clear()
        self._buffers.clear()


def run_step(graphs: GraphCache | None, key: tuple, step, *inputs) -> None:
    """``graphs.run``, or ``step(*inputs)`` eagerly when ``graphs`` is None."""
    if graphs is None:
        step(*inputs)
    else:
        graphs.run(key, step, *inputs)


def buffer(graphs: GraphCache | None, key: tuple, shape, dtype, device) -> torch.Tensor:
    """``graphs.buffer``, or a new tensor when ``graphs`` is None."""
    if graphs is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return graphs.buffer(key, shape, dtype)


def hold(graphs: GraphCache | None, key: tuple, value: torch.Tensor) -> torch.Tensor:
    """``graphs.hold``, or ``value`` itself when ``graphs`` is None."""
    return value if graphs is None else graphs.hold(key, value)
