"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), frozen from ``chip_smoke.py``. TF32 is the
card's fastest rate for float32 operands: the bound of any f32 product."""

HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
