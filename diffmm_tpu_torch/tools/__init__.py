"""The port's user-facing tools, counterparts of ``tools/sweep.py`` and
``tools/serve_bench.py``: ``python -m diffmm_tpu_torch.tools.sweep`` and
``python -m diffmm_tpu_torch.tools.serve_bench``."""
