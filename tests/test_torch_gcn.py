"""Port GCN (diffmm_tpu_torch/models/gcn.py) against diffmm_tpu/models/gcn.py
with JAX parameters carried over by convert.params_from_jax, on the dense
graph form (int8 blocks), three modalities.

Tolerance: the propagations round z to bf16 on both sides; a 1-ulp
difference in z (different f32 stacks) can flip that rounding, so outputs
compare at rtol 1e-2, atol 1e-3. project_features is f32: rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffmm_tpu.models import gcn as jg
from diffmm_tpu.ops.graph import build_dense_bi_adj_device as j_build
from diffmm_tpu_torch.convert import gcn_params_from_jax
from diffmm_tpu_torch.models import gcn as tg
from diffmm_tpu_torch.ops.graph import build_dense_bi_adj_device as t_build


def _random_edges(rng, U, I, nnz):
    flat = np.sort(rng.choice(U * I, size=nnz, replace=False))
    return (flat // I).astype(np.int32), (flat % I).astype(np.int32)


def test_gcn_mm_matches_with_converted_params(rng):
    U, I, d, dims = 40, 30, 16, [12, 20, 8]
    j_params = jg.init_gcn_params(jax.random.PRNGKey(3), U, I, d, dims)
    t_params = gcn_params_from_jax(jax.device_get(j_params))
    feats = [rng.standard_normal((I, f)).astype(np.float32) for f in dims]
    graphs = [_random_edges(rng, U, I, 150) for _ in range(4)]  # main + 3 modal
    t_adjs = [t_build(torch.as_tensor(r), torch.as_tensor(c), U, I) for r, c in graphs]
    j_adjs = [j_build(jnp.asarray(r), jnp.asarray(c), U, I, store_dtype=jnp.int8)
              for r, c in graphs]
    got = tg.gcn_mm(t_params, t_adjs[0], t_adjs[1:], [torch.as_tensor(f) for f in feats],
                    0.2, 0.5)
    want = jg.gcn_mm(j_params, j_adjs[0], j_adjs[1:], [jnp.asarray(f) for f in feats], 0.2, 0.5)
    for name in tg.GCNOutput._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-2, atol=1e-3, err_msg=name)
    for a, b in zip(tg.project_features(t_params, [torch.as_tensor(f) for f in feats]),
                    jg.project_features(j_params, [jnp.asarray(f) for f in feats])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_init_gcn_params_shapes_and_ranges():
    for dims in ([12, 20, 8], [12, 20]):
        t = tg.init_gcn_params(torch.Generator().manual_seed(0), 40, 30, 16, dims)
        j = jg.init_gcn_params(jax.random.PRNGKey(0), 40, 30, 16, dims)
        np.testing.assert_array_equal(t["modal_weight"].numpy(), np.asarray(j["modal_weight"]))
        assert t["u_embs"].shape == j["u_embs"].shape and t["i_embs"].shape == j["i_embs"].shape
        bound = np.sqrt(6.0 / (40 + 16))
        assert float(t["u_embs"].abs().max()) <= bound
        for tp, jp in zip(t["modal_proj"], j["modal_proj"]):
            assert tp["w"].shape == jp["w"].shape and tp["b"].shape == jp["b"].shape
            assert float(tp["w"].abs().max()) <= 1.0 / np.sqrt(tp["w"].shape[0])
