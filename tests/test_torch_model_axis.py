"""Model-axis training (the catalog over the mesh's model axis): the port's
steps and Coach on gloo ranks spawned by ``parallel/launch.py`` against the
JAX package's steps on ``make_mesh(2, model_parallel=2)`` and
``make_mesh(8, model_parallel=2)``, against the port at world size 1, and
rank against rank; after tests/test_parallel.py:58-79 and
tests/test_param_sharding.py.

Both JAX meshes compute the single-device function, and so must the port:
* one ``diffusion_block`` and one ``joint_block`` on each graph form at 1x2
  and 2x2, from the state and draws of tests/test_torch_parallel.py (Adam
  one step in): against the JAX step with its parameters placed by JAX's
  ``shard_model_params`` (sparse form and the diffusion step rtol 1e-4 /
  atol 1e-5, losses rtol 2e-4; the dense form's bf16 tolerance rtol 1e-2 /
  atol 1e-3), against the port at world size 1 (rtol 1e-5 / atol 1e-6), and
  the ranks' whole (gathered) state bitwise equal;
* the adjoint: each step's gradient, read back from the first Adam moment
  (``mu = 0.9 mu + 0.1 g``), equals the one-device gradient, not a multiple
  of it;
* ``train_epoch(0)`` and ``test_epoch`` at 1x2 against world size 1 within
  rel 2e-3 / abs 1e-5 (the JAX mesh test's tolerance), int4 blocks at 1x2
  bitwise the int8 ones, a fused chunk bitwise two single epochs;
* the rebuild at 1x2: the reverse diffusion's scores within 1e-5 of one
  device's, the edge buffers equal wherever no near-tie decides them;
* a checkpoint written at 1x2 holds whole arrays and restores into a 1x1
  mesh and into a Coach without a mesh, with the same state and eval;
* each rank holds half of ``i_embs``, of W1's catalog rows, of W2's columns
  and of ``b2``, each with its Adam moments.

JAX is imported inside the tests only: the spawned ranks import this module
to find their functions, and need torch alone.
"""

import copy

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks
from test_torch_parallel import FORMS, LR, I, U, _close, _coach, _config, _inputs

# the port's mesh -> (world size, model axis, the JAX mesh's device count)
MESHES = {"1x2": (2, 2, 2), "2x2": (4, 2, 8)}
STEP_TOL = (1e-5, 1e-6)
EPOCH_TOL = {"rel": 2e-3, "abs": 1e-5}


def _numpy(tensors) -> list[np.ndarray]:
    return [t.detach().to(torch.float32).numpy().copy() for t in tensors]


def _whole_state(coach) -> list[np.ndarray]:
    """The whole parameters and Adam moments (gathered over the model axis:
    every rank calls it), in leaf order."""
    from diffmm_tpu_torch.train.optim import tree_leaves

    w = coach._whole(coach.gcn_params, coach.dn_params, coach.gcn_opt_state, coach.dn_opt_states)
    out = tree_leaves(w["gcn_params"]) + tree_leaves(w["dn_params"])
    for s in (w["gcn_opt_state"], *w["dn_opt_states"]):
        out += s.mu + s.nu
    return _numpy(out)


def _blocks(coach, inp) -> dict:
    """One diffusion_block, then one joint_block, from ``inp``'s state and
    draws on the Coach's split; the losses, the metrics summed over the
    world and the whole state after each."""
    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.parallel.collectives import all_reduce_sum_
    from diffmm_tpu_torch.train import steps as ts

    split = coach.split
    coach.load_params(*copy.deepcopy(inp["params"]))
    coach.set_edge_buffers([torch.as_tensor(b) for b in inp["bufs"]])
    t = {k: torch.as_tensor(v) for k, v in inp["draws"].items()}
    feats = project_features(coach.gcn_params, coach.data.raw_feats)
    losses = ts.diffusion_block(
        coach.schedule, coach.dn_params, coach.dn_opt_states, feats, coach.gcn_params["i_embs"],
        coach.data.train_store, t["d_users"], t["d_weights"], LR, coach.hp(), I,
        t=t["d_t"], noise=t["d_noise"], split=split,
    )
    after_diffusion = _whole_state(coach)
    metrics = ts.joint_block(
        coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs, coach.data.raw_feats,
        t["users"], t["pos"], t["neg"], LR, coach.hp(), coach.config.base.cl_method,
        cl_noise=[torch.as_tensor(n) for n in inp["cl_noise"]], split=split,
    )
    if split is not None:
        metrics = all_reduce_sum_(metrics, split.world.group)
    return {"losses": losses.numpy(), "diffusion_state": after_diffusion, "metrics": metrics.numpy(),
            "joint_state": _whole_state(coach)}


def _epoch(coach) -> dict:
    result = coach.train_epoch(0)
    return {"train": result, "eval": coach.test_epoch(), "state": _whole_state(coach)}


def _rebuild(coach, inp) -> dict:
    """The reverse diffusion's scores of every user (sampling_step 2, one
    raw draw made whole), gathered over the model axis, and the edge
    buffers of ``rebuild_graphs`` from ``inp``'s parameters."""
    from diffmm_tpu_torch.data.membership import gather_rows
    from diffmm_tpu_torch.diffusion.gaussian import generate_view
    from diffmm_tpu_torch.parallel.collectives import placed_all_reduce
    from diffmm_tpu_torch.train import steps as ts

    coach.load_params(*copy.deepcopy(inp["params"]))
    split = coach.split
    lo, hi = (0, I) if split is None else (split.lo, split.hi)
    denoisers, apply = ts.rebuild_forward(coach.dn_params, "f32", None, split)
    x0 = gather_rows(coach.data.train_store, torch.arange(U), I, (lo, hi))
    raw = torch.randn((U, I), generator=torch.Generator().manual_seed(9))
    scores = []
    for den in denoisers:
        view = generate_view(coach.schedule, den, x0, 2, noise=raw, denoise_apply=apply, cols=(lo, hi))
        if split is not None and split.cat is not None:
            view = placed_all_reduce(view, lo, I, split.cat.group, dim=1)
        scores.append(view.numpy())
    return {"scores": scores, "bufs": _numpy(coach.rebuild_graphs())}


def _shapes(coach) -> dict:
    """This rank's shapes of the catalog-wide leaves and their moments."""
    from diffmm_tpu_torch.train.optim import tree_leaves

    dn, g = coach.dn_params[0], coach.gcn_params
    out = {"i_embs": tuple(g["i_embs"].shape), "w1": tuple(dn["in_layers"][0]["w"].shape),
           "w2": tuple(dn["out_layers"][-1]["w"].shape), "b2": tuple(dn["out_layers"][-1]["b"].shape),
           "u_embs": tuple(g["u_embs"].shape)}
    for name, state, params in (("gcn", coach.gcn_opt_state, g), ("dn", coach.dn_opt_states[0], dn)):
        out[f"{name}_moments"] = [tuple(t.shape) for t in state.mu + state.nu] == \
            [tuple(t.shape) for t in tree_leaves(params) * 2]
    return out


def _roundtrip(coach, inp) -> dict:
    """``shard_params`` then ``gather_params`` (and the Adam states' pair)
    of the whole JAX-converted trees of ``inp``: bitwise the trees."""
    from diffmm_tpu_torch.convert import tree_to
    from diffmm_tpu_torch.parallel.sharding import (
        gather_adam_state,
        gather_params,
        place_adam_state,
        shard_params,
    )
    from diffmm_tpu_torch.train.optim import tree_leaves

    split = coach.split
    gcn, dn, g_state, d_states = inp["params"]
    out = {}
    for name, tree, place in (("gcn", gcn, split.gcn_place), ("dn", dn[0], split.dn_place)):
        whole = tree_to(tree, "cpu")
        back = gather_params(shard_params(whole, place, split), place, split)
        out[name] = all(torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(back), strict=True))
    for name, state, place in (("gcn_state", g_state, split.gcn_place), ("dn_state", d_states[0], split.dn_place)):
        back = gather_adam_state(place_adam_state(state, place, split), place, split)
        out[name] = all(torch.equal(a, b) for a, b in zip(state.mu + state.nu, back.mu + back.nu, strict=True))
    return out


def _rank_work(inputs, model: int, full: bool):
    """Everything the tests read from one mesh's ranks, in one spawn."""
    import os
    import tempfile

    import torch.distributed as dist

    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    mesh = make_mesh(model_parallel=model)
    out = {}
    for form, cl_method in FORMS.items():
        coach = _coach(_config(form, cl_method), mesh)
        out[f"blocks_{form}"] = _blocks(coach, inputs[form])
    if not full:
        return out
    out["shapes"] = _shapes(coach)
    out["roundtrip"] = _roundtrip(coach, inputs["dense"])
    for form, cl_method in FORMS.items():
        out[f"epoch_{form}"] = _epoch(_coach(_config(form, cl_method), mesh))
    out["epoch_int4"] = _epoch(_coach(_config("dense", 0, dense_store="int4"), mesh))
    out["rebuild"] = _rebuild(_coach(_config("dense", 0), mesh), inputs["dense"])
    fused = _coach(_config("dense", 0, epoch_scan=2, tstEpoch=1), mesh)
    results, evals, _ = fused.train_epochs_fused(0, 2, "test")
    single = _coach(_config("dense", 0), mesh)
    out["fused"] = {"results": results, "evals": evals, "state": _whole_state(fused),
                    "single": [single.train_epoch(0), single.test_epoch(), single.train_epoch(1),
                               single.test_epoch()], "single_state": _whole_state(single)}
    directory = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(directory, src=0)
    saver = _coach(_config("sparse", 1), mesh)
    saver.ckpt = CheckpointManager(directory[0])
    saver.train_epoch(0)
    saver.test_epoch()
    saver.capture_best(0)
    saver.save_checkpoint(0, {"Recall": 0.0})
    restored = _coach(_config("sparse", 1), mesh)
    restored.ckpt = saver.ckpt
    restored.restore_checkpoint()
    out["checkpoint"] = {"saved": _whole_state(saver), "restored": _whole_state(restored),
                         "eval": restored.test_epoch(), "files": sorted(os.listdir(directory[0])),
                         "dir": directory[0]}
    return out


def _restore_on_mesh(directory):
    """A 1x1 mesh's Coach restored from ``directory``: state and eval."""
    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    coach = _coach(_config("sparse", 1), make_mesh(1, model_parallel=1))
    coach.ckpt = CheckpointManager(directory)
    coach.restore_checkpoint()
    return {"state": _whole_state(coach), "eval": coach.test_epoch()}


@pytest.fixture(scope="module")
def setup():
    made = {form: _inputs(form, cl) for form, cl in FORMS.items()}
    inputs = {form: made[form][0] for form in FORMS}
    ranks = {label: run_ranks(_rank_work, world, (inputs, model, label == "1x2"))
             for label, (world, model, _) in MESHES.items()}
    one = {form: _blocks(_coach(_config(form, cl)), inputs[form]) for form, cl in FORMS.items()}
    return made, ranks, one


def _assert_ranks_equal(ranks, key):
    for out in ranks[1:]:
        for x, y in zip(ranks[0][key], out[key], strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("form", list(FORMS))
def test_blocks_match_one_device_and_ranks_agree(setup, mesh, form):
    """The steps on the mesh against the port's world size 1, and every
    rank's whole state bitwise equal."""
    _, ranks, one = setup
    outs = [r[f"blocks_{form}"] for r in ranks[mesh]]
    for key in ("diffusion_state", "joint_state"):
        _assert_ranks_equal(outs, key)
        _close(outs[0][key], one[form][key], *STEP_TOL)
    np.testing.assert_allclose(outs[0]["losses"], one[form]["losses"], *STEP_TOL)
    np.testing.assert_allclose(outs[0]["metrics"], one[form]["metrics"], *STEP_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("form", list(FORMS))
def test_adjoint_gives_the_one_device_gradient(setup, mesh, form):
    """Every gradient, read back from the first moment the step leaves
    (``g = (mu' - 0.9 mu) / 0.1``), is the one-device gradient: a value whose
    cotangent each model rank added in again would come out twice as
    large."""
    made, ranks, one = setup
    _, _, g_state, d_states = made[form][0]["params"]
    n_g, n_d = len(g_state.mu), len(d_states[0].mu)
    n_p = n_g + n_d * len(d_states)
    # _whole_state: the parameters, then each model's mu and nu
    where = [("joint_state", n_p + j, g_state.mu[j]) for j in range(n_g)]
    where += [("diffusion_state", n_p + 2 * n_g + 2 * m * n_d + j, s.mu[j])
              for m, s in enumerate(d_states) for j in range(n_d)]
    got_out = ranks[mesh][0][f"blocks_{form}"]
    for key, at, mu0 in where:
        got = (got_out[key][at] - 0.9 * mu0.numpy()) / 0.1
        want = (one[form][key][at] - 0.9 * mu0.numpy()) / 0.1
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=f"{key} leaf {at}")


def _j_inputs(form, js, mesh):
    """The JAX step's parameters placed as the JAX mesh Coach places them
    (``shard_model_params``, ``place_adam_state``), its adjacencies (the
    sparse edges over the data axis, the dense blocks by catalog columns)."""
    import jax

    from diffmm_tpu.parallel.sharding import (
        _shard_adj,
        catalog_sharded_or_replicated,
        place_adam_state,
        replicated,
        shard_model_params,
    )

    gcn, dn, g_sh, d_sh = shard_model_params(js["gcn"], js["dn"], mesh)
    g_state = place_adam_state(js["g_state"], g_sh, mesh)
    d_states = [place_adam_state(s, sh, mesh) for s, sh in zip(js["d_states"], d_sh)]

    def place(a):
        if form == "sparse":
            return _shard_adj(a, mesh)
        return a._replace(mat=jax.device_put(a.mat, catalog_sharded_or_replicated(a.mat, mesh)),
                          s_user=jax.device_put(a.s_user, replicated(mesh)),
                          s_item=jax.device_put(a.s_item, replicated(mesh)))

    return gcn, dn, g_state, d_states, place(js["adj"]), tuple(place(a) for a in js["modal_adjs"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("form", list(FORMS))
def test_joint_block_matches_jax_model_axis(setup, mesh, form):
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.parallel import make_mesh, shard_batch
    from diffmm_tpu.parallel.sharding import replicate
    from diffmm_tpu_torch.train.optim import tree_leaves

    made, ranks, _ = setup
    port_in, js = made[form]
    j_mesh = make_mesh(MESHES[mesh][2], model_parallel=2)
    gcn, _, g_state, _, adj, modal_adjs = _j_inputs(form, js, j_mesh)
    d = port_in["draws"]
    j_params, _, j_metrics = js["steps"].joint_step(
        gcn, g_state, adj, modal_adjs, replicate(js["data"].raw_feats, j_mesh),
        *(shard_batch(jnp.asarray(d[k]), j_mesh) for k in ("users", "pos", "neg")),
        js["key"], jnp.float32(LR), {k: jnp.float32(v) for k, v in js["hp"].items()},
    )
    tol = dict(rtol=1e-4, atol=1e-5) if form == "sparse" else dict(rtol=1e-2, atol=1e-3)
    out = ranks[mesh][0][f"blocks_{form}"]
    np.testing.assert_allclose(out["metrics"], np.asarray(j_metrics), **tol)
    n = len(tree_leaves(js["gcn"]))
    _close(out["joint_state"][:n], [np.asarray(x) for x in jax.tree_util.tree_leaves(j_params)],
           tol["rtol"], tol["atol"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_diffusion_block_matches_jax_model_axis(setup, mesh):
    """The diffusion step on the CSR store against the JAX step with the
    denoisers' wide layers on the model axis and the user block over the
    data axis."""
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.parallel import make_mesh, shard_batch
    from diffmm_tpu.parallel.sharding import replicate
    from diffmm_tpu_torch.train.optim import tree_leaves
    from test_torch_train_diffusion import _setup

    made, ranks, _ = setup
    port_in, js = made["sparse"]
    _, j_data, j_steps = _setup("sparse")
    j_mesh = make_mesh(MESHES[mesh][2], model_parallel=2)
    gcn, dn, _, d_states, _, _ = _j_inputs("sparse", js, j_mesh)
    d = port_in["draws"]
    j_dn, _, j_losses = j_steps.diffusion_step(
        dn, d_states, gcn, replicate(j_data.raw_feats, j_mesh), replicate(j_data.train_store, j_mesh),
        shard_batch(jnp.asarray(d["d_users"]), j_mesh), shard_batch(jnp.asarray(d["d_weights"]), j_mesh),
        js["d_key"], jnp.float32(LR), {k: jnp.float32(v) for k, v in js["hp"].items()},
    )
    out = ranks[mesh][0]["blocks_sparse"]
    np.testing.assert_allclose(out["losses"], np.asarray(j_losses), rtol=2e-4, atol=1e-5)
    n_gcn = len(tree_leaves(js["gcn"]))
    n_dn = sum(len(tree_leaves(p)) for p in js["dn"])
    _close(out["diffusion_state"][n_gcn:n_gcn + n_dn],
           [np.asarray(x) for p in j_dn for x in jax.tree_util.tree_leaves(p)], 1e-4, 1e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse", "int4"])
def test_epoch_and_eval_match_one_device(setup, kind):
    """train_epoch(0) + test_epoch at 1x2 against the port without a mesh
    (tests/test_parallel.py:58-79's tolerance), the ranks' whole state
    bitwise equal; int4 blocks bitwise the int8 ones on the same mesh."""
    _, ranks, _ = setup
    outs = [r[f"epoch_{kind}"] for r in ranks["1x2"]]
    _assert_ranks_equal(outs, "state")
    form = "dense" if kind == "int4" else kind
    settings = {"dense_store": "int4"} if kind == "int4" else {}
    one = _epoch(_coach(_config(form, FORMS[form], **settings)))
    for part in ("train", "eval"):
        assert set(outs[0][part]) == set(one[part])
        for k in one[part]:
            assert outs[0][part][k] == pytest.approx(one[part][k], **EPOCH_TOL), (part, k)
        assert outs[1][part] == outs[0][part]
    if kind == "int4":
        int8 = ranks["1x2"][0]["epoch_dense"]
        assert outs[0]["train"] == int8["train"] and outs[0]["eval"] == int8["eval"]
        for x, y in zip(outs[0]["state"], int8["state"], strict=True):
            np.testing.assert_array_equal(x, y)


def test_rebuild_matches_one_device(setup):
    """The reverse diffusion's scores at 1x2 (K2's partial products summed
    over the model axis, K3 on the rank's columns; their plain versions
    here) within 1e-5 of one device's, and the rebuilt edges (the top-k
    merged over the model axis) equal wherever the k-th and the (k+1)-th
    one-device scores are more than 1e-5 apart."""
    made, ranks, _ = setup
    one_coach = _coach(_config("dense", 0))
    one = _rebuild(one_coach, made["dense"][0])
    host = one_coach.host
    mesh_out = ranks["1x2"][0]["rebuild"]
    for got, want in zip(mesh_out["scores"], one["scores"], strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for r in ranks["1x2"][1:]:
        for x, y in zip(r["rebuild"]["bufs"], mesh_out["bufs"], strict=True):
            np.testing.assert_array_equal(x, y)
    # sampling_step 0: the scores of the clean rows decide the edges
    from diffmm_tpu_torch.data.membership import gather_rows
    from diffmm_tpu_torch.diffusion.gaussian import generate_view
    from diffmm_tpu_torch.train import steps as ts

    denoisers, apply = ts.rebuild_forward(one_coach.dn_params, "f32")
    x0 = gather_rows(one_coach.data.train_store, torch.arange(U), I)
    ties = 0
    for m, (got, want) in enumerate(zip(mesh_out["bufs"], one["bufs"], strict=True)):
        scores = generate_view(one_coach.schedule, denoisers[m], x0, 0, denoise_apply=apply).numpy()
        for u in range(U):
            lo, k = host.csr_offsets[u], host.user_degrees[u]
            if set(got[lo:lo + k]) == set(want[lo:lo + k]):
                continue
            top = np.sort(scores[u])[::-1]
            assert k < I and top[k - 1] - top[k] <= 1e-5, (m, u)
            ties += 1
    assert ties <= 2


def test_fused_chunk_equals_single_epochs(setup):
    """``train_epochs_fused`` at 1x2 equals two single epochs (losses,
    evals, state) exactly, as tests/test_torch_fused.py holds on one
    device."""
    _, ranks, _ = setup
    for out in ranks["1x2"]:
        f = out["fused"]
        assert f["results"] == [f["single"][0], f["single"][2]]
        assert f["evals"] == [f["single"][1], f["single"][3]]
        for x, y in zip(f["state"], f["single_state"], strict=True):
            np.testing.assert_array_equal(x, y)


def test_checkpoint_restores_into_any_mesh(setup):
    """A checkpoint written at 1x2 holds whole arrays: it restores on the
    mesh, on a 1x1 mesh and into a Coach without a mesh, each with the
    state written and the same eval."""
    import shutil

    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    _, ranks, _ = setup
    ck = ranks["1x2"][0]["checkpoint"]
    assert ck["files"] == ["ckpt_00000000.pt"]
    _, arrays, _ = CheckpointManager(ck["dir"]).restore()
    assert arrays["gcn_params"]["i_embs"].shape == (I, 16)
    assert arrays["dn_params"][0]["out_layers"][-1]["w"].shape[1] == I
    one = _coach(_config("sparse", 1))
    one.ckpt = CheckpointManager(ck["dir"])
    one.restore_checkpoint()
    (mesh1,) = run_ranks(_restore_on_mesh, 1, (ck["dir"],))
    shutil.rmtree(ck["dir"])
    for out in ranks["1x2"]:
        for x, y in zip(out["checkpoint"]["restored"], ck["saved"], strict=True):
            np.testing.assert_array_equal(x, y)
        assert out["checkpoint"]["eval"] == ck["eval"]
    for state, result in ((_whole_state(one), one.test_epoch()), (mesh1["state"], mesh1["eval"])):
        for x, y in zip(state, ck["saved"], strict=True):
            np.testing.assert_array_equal(x, y)
        for k, v in ck["eval"].items():
            assert result[k] == pytest.approx(v, **EPOCH_TOL), k


def test_ranks_hold_half_of_the_catalog_state(setup):
    """At 1x2 each rank holds I / 2 rows of ``i_embs``, of W1's catalog rows
    (plus the d_emb time rows) and of ``b2``, and I / 2 columns of W2, with
    Adam moments of the same shapes; ``u_embs`` stays whole."""
    _, ranks, _ = setup
    for out in ranks["1x2"]:
        s = out["shapes"]
        assert s["i_embs"] == (I // 2, 16) and s["u_embs"] == (U, 16)
        assert s["w1"] == (I // 2 + 10, 32) and s["w2"] == (32, I // 2) and s["b2"] == (I // 2,)
        assert s["gcn_moments"] and s["dn_moments"]


def test_shard_and_gather_params_round_trip(setup):
    """The whole JAX-converted parameters and Adam states, cut into the
    ranks' slices and gathered back, are the trees bit for bit."""
    _, ranks, _ = setup
    for out in ranks["1x2"]:
        assert out["roundtrip"] == {"gcn": True, "dn": True, "gcn_state": True, "dn_state": True}


def test_placements_are_jax_at_2x2():
    """The placement trees of a 2x2 mesh put on the model axis the leaves
    JAX's ``gcn_param_shardings`` and ``denoise_param_shardings`` put there,
    dim for dim (tests/test_param_sharding.py:31-48); an uneven catalog
    stays replicated. The one difference: where the axis divides
    ``item_num + d_emb`` but not ``item_num``, JAX cuts W1 by its rows and
    the port, which cuts it along the catalog, keeps it whole."""
    import jax

    from diffmm_tpu.parallel import MODEL_AXIS, make_mesh
    from diffmm_tpu.parallel.sharding import denoise_param_shardings as j_dn_place
    from diffmm_tpu.parallel.sharding import gcn_param_shardings as j_gcn_place
    from diffmm_tpu_torch.parallel.sharding import (
        COLS,
        REPLICATED,
        ROWS,
        denoise_param_shardings,
        gcn_param_shardings,
    )
    from diffmm_tpu_torch.train.optim import tree_leaves

    class TwoByTwo:  # the placements read the axis sizes only
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    j_mesh = make_mesh(4, model_parallel=2)
    named = {ROWS: (MODEL_AXIS,), COLS: (None, MODEL_AXIS), REPLICATED: ()}
    for item_num, d_emb in ((40, 10), (37, 10), (40, 9), (37, 9)):
        gcn = {"u_embs": (5, 4), "i_embs": (item_num, 4), "modal_proj": [{"w": (3, 4), "b": (4,)}],
               "modal_weight": (1,)}
        dn = {"in_layers": [{"w": (item_num + d_emb, 8), "b": (8,)}],
              "out_layers": [{"w": (8, item_num), "b": (item_num,)}],
              "emb": {"w": (d_emb, d_emb), "b": (d_emb,)}, "gate": {"w": (4, 4), "b": (4,)}}
        for shapes, j_fn, t_fn in ((gcn, j_gcn_place, gcn_param_shardings),
                                   (dn, j_dn_place, denoise_param_shardings)):
            j_tree = jax.tree.map(np.zeros, shapes, is_leaf=lambda x: isinstance(x, tuple))
            t_tree = jax.tree.map(torch.zeros, shapes, is_leaf=lambda x: isinstance(x, tuple))
            want = [_norm(sh.spec) for sh in jax.tree_util.tree_leaves(j_fn(j_tree, j_mesh))]
            got = [named[p] for p in tree_leaves(t_fn(t_tree, TwoByTwo()))]
            if shapes is dn and item_num % 2 and (item_num + d_emb) % 2 == 0:
                at = 5  # in_layers[0].w, after emb.b, emb.w, gate.b, gate.w, in_layers[0].b
                assert want[at] == (MODEL_AXIS,) and got[at] == ()
                want[at] = ()
            assert got == want, (item_num, d_emb)


def _norm(spec) -> tuple:
    """A JAX PartitionSpec as the port names it: its trailing Nones cut."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)
