"""diffmm_tpu_torch: the DiffMM recommender in PyTorch for one NVIDIA H100.

A port of ``diffmm_tpu`` (JAX on a TPU), kept beside it and held against it
module by module. The module layout mirrors ``diffmm_tpu`` so that each
counterpart sits at the same path. The port imports ``torch`` and never
``jax`` or ``diffmm_tpu``.

This slice covers the serving path on the dense graph form:

1. phase-2 graph rebuild by reverse diffusion (``train/steps.py``
   ``rebuild_epoch``, driven by ``train/coach.py`` ``Coach.rebuild_graphs``);
2. the dense-form GCN forward (``models/gcn.py`` ``gcn_mm``);
3. full-catalog ranking eval (``eval/ranking.py``, ``Coach.test_epoch``);
4. index build, save/load and ``recommend`` (``eval/serving.py``).

Its hand-written Hopper kernels are in ``csrc/`` and are wrapped by
``ops/kernels/spmm_dual.py`` and ``ops/kernels/denoise_mlp.py``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
