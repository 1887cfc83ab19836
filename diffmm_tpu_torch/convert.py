"""Carry a JAX run's parameters, optimizer state and sparse-form graph state
into the port.

:func:`params_from_jax` takes the ``diffmm_tpu`` parameter pytrees as numpy
arrays (``jax.device_get`` of ``Coach.gcn_params`` and ``Coach.dn_params``)
and returns the port's parameters, after which both packages compute the
same functions; :func:`adam_state_from_jax` does the same for an Adam state
(``Coach.gcn_opt_state``, each of ``Coach.dn_opt_states``).
:func:`bi_adj_from_jax` and :func:`train_csr_from_jax` do the same for a
sparse-form adjacency (``BiAdj``) and a CSR train store (``TrainCSR``),
read field by field as numpy arrays.

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

from diffmm_tpu_torch.data.membership import TrainCSR, make_train_csr
from diffmm_tpu_torch.ops.graph import BiAdj, assemble_bi_adj
from diffmm_tpu_torch.train.optim import AdamState, tree_leaves


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


def adam_state_from_jax(state, device: str | torch.device = "cpu") -> AdamState:
    """An optax ``ScaleByAdamState`` (``count``, and ``mu``/``nu`` trees
    shaped like the parameters, numpy leaves) as the port's
    :class:`~diffmm_tpu_torch.train.optim.AdamState`: the count as a host
    integer, the moments in :func:`tree_leaves` order (the order JAX
    flattens the same tree in). With it both packages step on from the same
    step k > 0."""
    return AdamState(
        count=int(np.asarray(state.count)),
        mu=tree_leaves(tree_to(state.mu, device)),
        nu=tree_leaves(tree_to(state.nu, device)),
    )


def bi_adj_from_jax(adj, device: str | torch.device = "cpu") -> BiAdj:
    """A JAX ``BiAdj`` (numpy fields, e.g. ``jax.device_get`` of one) as the
    port's: the same edges, permutation and scales, with the port's
    item-major pair and offsets made from them (``rank_aux`` is dropped)."""

    def put(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    scales = [put(adj.s_user, np.float32), put(adj.s_item, np.float32)]
    return assemble_bi_adj(
        put(adj.ui_rows, np.int32), put(adj.ui_cols, np.int32), put(adj.iu_perm, np.int32),
        scales[0].shape[0], scales[1].shape[0], scales,
    )


def train_csr_from_jax(store, device: str | torch.device = "cpu") -> TrainCSR:
    """A JAX ``TrainCSR`` (numpy fields) as the port's, head/tail plan kept."""

    def put(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=device)

    heavy = None if store.heavy_ids is None else np.asarray(store.heavy_ids)
    return make_train_csr(put(store.cols), put(store.offsets), put(store.degrees),
                          store.k_max, store.k_cut, heavy)
