"""Train membership rows for a user batch, dense store.

Counterpart of the dense branch of ``diffmm_tpu/data/membership.py``
``gather_rows`` (lines 132-133): one contiguous row gather of the (U, I)
int8 matrix, cast to f32. The O(nnz) CSR store comes with the sparse-form
slice.
"""

from __future__ import annotations

import torch


def gather_rows(store: torch.Tensor, users: torch.Tensor, item_num: int) -> torch.Tensor:
    """(B, item_num) f32 0/1 train rows for a user batch."""
    if store.dim() != 2 or store.shape[1] != item_num:
        raise NotImplementedError(
            "only the dense (U, I) train store is ported (ROADMAP.md A, slice 3: CSR store)"
        )
    return store.index_select(0, users.long()).to(torch.float32)
