"""diffmm_tpu_torch: the DiffMM recommender in PyTorch for one NVIDIA H100.

A port of ``diffmm_tpu`` (JAX on a TPU), kept beside it and held against it
module by module. The module layout mirrors ``diffmm_tpu`` so that each
counterpart sits at the same path. The port imports ``torch`` and never
``jax`` or ``diffmm_tpu``.

It trains and serves on both graph forms (dense (U, I) blocks, sparse
O(nnz) edges), through ``python -m diffmm_tpu_torch`` (``cli.py``) or the
``train/coach.py`` ``Coach``:

1. an epoch (``Coach.train_epoch``): negative sampling
   (``data/sampling.py``), diffusion training of one denoiser per modality,
   the graph rebuild by reverse diffusion, joint GCN training with BPR, L2
   and two contrastive losses (``train/steps.py``), Adam (``train/optim.py``);
2. full-catalog ranking eval (``eval/ranking.py``, ``Coach.test_epoch``) and
   best-epoch capture (``Coach.run``);
3. index build, save/load and ``recommend`` (``eval/serving.py``).

Its hand-written Hopper kernels are in ``csrc/`` and are wrapped by
``ops/kernels/``; the propagations' backwards launch them too. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.

On several cards (``parallel/``, ``--mesh``/``--distributed``) it runs one
process per card over a ``(data, model)`` mesh (:func:`make_mesh`), as the
JAX package's mesh does.
"""

from diffmm_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
