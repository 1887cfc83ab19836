"""Carry a JAX run's parameters into the port.

:func:`params_from_jax` takes the ``diffmm_tpu`` parameter pytrees as numpy
arrays (``jax.device_get`` of ``Coach.gcn_params`` and ``Coach.dn_params``)
and returns the port's parameters, after which both packages compute the
same functions.

Layout: both packages store a Linear as ``{"w": (d_in, d_out), "b":
(d_out,)}`` and compute ``x @ w + b`` (torch's ``nn.Linear`` keeps the
transpose, ``(d_out, d_in)``; the port does not use it), so the weights
carry over unchanged:

* GCN: ``u_embs`` (U, d), ``i_embs`` (I, d), ``modal_proj[m]`` with ``w``
  (feat_dim, d), ``modal_weight`` (M,).
* Denoiser: ``in_layers[0].w`` (I + d_emb, H) — the first I rows are the
  denoise_mlp kernel's W1x — ``out_layers[0].w`` (H, I), ``emb.w`` (d_emb,
  d_emb), ``gate.w`` (latdim, latdim).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_to(tree, device):
    """A parameter tree (dicts and lists of arrays or tensors) as f32
    tensors on ``device``, copied."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32, copy=True)
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def gcn_params_from_jax(gcn_params: dict, device: str | torch.device = "cpu") -> dict:
    """The GCN pytree (``u_embs``, ``i_embs``, ``modal_proj``, ``modal_weight``)."""
    expected = {"u_embs", "i_embs", "modal_proj", "modal_weight"}
    if set(gcn_params) != expected:
        raise ValueError(f"GCN params must have keys {sorted(expected)}, got {sorted(gcn_params)}")
    return tree_to(gcn_params, device)


def denoise_params_from_jax(dn_params: dict, device: str | torch.device = "cpu") -> dict:
    """One denoiser pytree (``in_layers``, ``out_layers``, ``emb``, ``gate``)."""
    expected = {"in_layers", "out_layers", "emb", "gate"}
    if set(dn_params) != expected:
        raise ValueError(f"denoiser params must have keys {sorted(expected)}, got {sorted(dn_params)}")
    return tree_to(dn_params, device)


def params_from_jax(gcn_params: dict, dn_params_list: list, device: str | torch.device = "cpu"):
    """``(gcn_params, dn_params)`` in the port's layout on ``device``."""
    return (
        gcn_params_from_jax(gcn_params, device),
        [denoise_params_from_jax(p, device) for p in dn_params_list],
    )
