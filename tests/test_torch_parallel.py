"""Training on the data axis of a mesh: the port's steps and Coach at world
size 2 (two gloo ranks spawned by ``parallel/launch.py``) against the JAX
package's steps on a (2, 1) mesh, against the port at world size 1, and
rank against rank; after tests/test_parallel.py:58-79.

The JAX mesh computes the single-device function, and so must the port's:
* one ``joint_block`` and one ``diffusion_block`` from the same parameters,
  Adam state one step in (count 1, so each update is smooth in its
  gradient) and injected draws (the JAX step's own: the CL uniforms of
  tests/test_torch_joint.py, the timesteps and noise of
  tests/test_torch_train_diffusion.py): against the port at world size 1,
  f32 rtol 1e-5 / atol 1e-6 (the same terms summed in another order; the
  dense form's K1 backward rounds the summed cotangent to bf16, as one
  device rounds its own); against
  the JAX step on its (2, 1) mesh, the tolerances of those one-device parity
  tests (sparse and the diffusion step: rtol 1e-4 / atol 1e-5, losses rtol
  2e-4; dense: the bf16 tolerance rtol 1e-2 / atol 1e-3);
* ``train_epoch(0)`` and ``test_epoch`` at world size 2 against world size
  1 within rel 2e-3 / abs 1e-5, the JAX mesh test's tolerance;
* both ranks' parameters and Adam moments bitwise equal after each step;
* the batch guard and the model-axis refusal (ROADMAP.md A7b).

JAX is imported inside the tests only: the spawned ranks import this module
to find their function, and need torch alone.
"""

import copy
import os

import numpy as np
import pytest
import torch

from diffmm_tpu_torch.parallel.launch import run_ranks

U, I, B, LR = 50, 40, 16, 1e-3
FORMS = {"dense": 0, "sparse": 1}  # graph form -> cl_method


class _Quiet:
    def info(self, message):
        pass


def _config(form, cl_method=0, **train):
    from diffmm_tpu_torch.config import Config

    cfg = Config()
    cfg.base.seed = 7
    cfg.base.latdim = 16
    cfg.base.denoise_dim = "[32]"
    cfg.base.cl_method = cl_method
    cfg.train.batch = B
    cfg.train.test_batch = 8
    cfg.train.epoch = 3
    cfg.train.graph_form = form
    cfg.hyper.steps = 5
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


def _coach(cfg, mesh=None):
    from diffmm_tpu_torch.data.synthetic import make_synthetic_host_data
    from diffmm_tpu_torch.train.coach import Coach

    return Coach(cfg, make_synthetic_host_data(cfg, user_num=U, item_num=I, seed=3), device="cpu",
                 log=_Quiet(), mesh=mesh)


def _state(coach) -> list[np.ndarray]:
    from diffmm_tpu_torch.train.optim import tree_leaves

    out = tree_leaves(coach.gcn_params) + tree_leaves(coach.dn_params)
    for s in (coach.gcn_opt_state, *coach.dn_opt_states):
        out += s.mu + s.nu
    return [t.detach().numpy().copy() for t in out]


def _blocks(coach, inp, shard):
    """One diffusion_block, then one joint_block (the first changes no GCN
    parameter, so both start from ``inp``'s state), with ``inp``'s draws;
    the losses, the metrics and the state after each."""
    from diffmm_tpu_torch.models.gcn import project_features
    from diffmm_tpu_torch.train import steps as ts

    coach.load_params(*copy.deepcopy(inp["params"]))
    coach.set_edge_buffers([torch.as_tensor(b) for b in inp["bufs"]])
    t = {k: torch.as_tensor(v) for k, v in inp["draws"].items()}
    feats = project_features(coach.gcn_params, coach.data.raw_feats)
    losses = ts.diffusion_block(
        coach.schedule, coach.dn_params, coach.dn_opt_states, feats, coach.gcn_params["i_embs"],
        coach.data.train_store, t["d_users"], t["d_weights"], LR, coach.hp(), I,
        t=t["d_t"], noise=t["d_noise"], shard=shard,
    )
    after_diffusion = _state(coach)
    metrics = ts.joint_block(
        coach.gcn_params, coach.gcn_opt_state, coach.data.adj, coach.modal_adjs, coach.data.raw_feats,
        t["users"], t["pos"], t["neg"], LR, coach.hp(), coach.config.base.cl_method,
        cl_noise=[torch.as_tensor(n) for n in inp["cl_noise"]], shard=shard,
    )
    return {"metrics": metrics.numpy(), "joint_state": _state(coach), "losses": losses.numpy(),
            "diffusion_state": after_diffusion}


def _epoch(coach):
    result = coach.train_epoch(0)
    return {"train": result, "eval": coach.test_epoch(), "state": _state(coach)}


def _rank_work(inputs):
    """Everything the tests read from the two ranks, in one spawn."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from diffmm_tpu_torch.parallel import make_mesh
    from diffmm_tpu_torch.utils.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    mesh = make_mesh()
    out = {}
    for form, cl_method in FORMS.items():
        coach = _coach(_config(form, cl_method), mesh)
        out[f"blocks_{form}"] = _blocks(coach, inputs[form], coach.data_shard)
        out[f"epoch_{form}"] = _epoch(_coach(_config(form, cl_method), mesh))
    # a fused chunk of two epochs against two single epochs, and a checkpoint
    # restored into a new Coach (sparse form, eval on the chunk's boundaries)
    fused = _coach(_config("sparse", 1, epoch_scan=2, tstEpoch=1), mesh)
    results, evals, _ = fused.train_epochs_fused(0, 2, "test")
    single = _coach(_config("sparse", 1), mesh)
    out["fused"] = {"results": results, "evals": evals, "state": _state(fused),
                    "single": [single.train_epoch(0), single.test_epoch(), single.train_epoch(1),
                               single.test_epoch()], "single_state": _state(single)}
    directory = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(directory, src=0)
    saver = _coach(_config("sparse", 1), mesh)
    saver.ckpt = CheckpointManager(directory[0])
    saver.train_epoch(0)
    saver.save_checkpoint(0, {"Recall": 0.0})
    restored = _coach(_config("sparse", 1), mesh)
    restored.ckpt = saver.ckpt
    restored.restore_checkpoint()
    out["restored"] = (_state(restored), _state(saver), sorted(os.listdir(directory[0])))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(directory[0])
    errors = {}
    for name, cfg, m in (("batch", _config("dense", batch=15), mesh),
                         ("a7b", _config("dense"), make_mesh(2, model_parallel=2))):
        try:
            _coach(cfg, m)
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    return out


def _inputs(form, cl_method):
    """The shared state and draws of the block tests (made with the JAX
    parity tests' helpers), and the JAX side's setup."""
    import jax

    from diffmm_tpu_torch.convert import adam_state_from_jax
    from diffmm_tpu_torch.train.optim import tree_map
    from test_torch_joint import _adam_state, _cl_noise, _setup
    from test_torch_train_diffusion import _draws

    rng = np.random.default_rng(5)
    t_coach, steps, adj, modal_adjs, data, bufs = _setup(form, cl_method)
    gcn = tree_map(lambda p: p.numpy().copy(), t_coach.gcn_params)
    dn = [tree_map(lambda p: p.numpy().copy(), p) for p in t_coach.dn_params]
    g_state = _adam_state(rng, gcn)
    d_states = [_adam_state(rng, p) for p in dn]
    host = t_coach.host
    pick = rng.integers(0, host.nnz, B)
    key = jax.random.PRNGKey(4)
    d_key = jax.random.PRNGKey(2)
    d_draws = [_draws(k, B, I) for k in jax.random.split(d_key, t_coach.n_modal)]
    draws = {
        "users": host.train_rows[pick].astype(np.int32), "pos": host.train_cols[pick].astype(np.int32),
        "neg": rng.integers(0, I, B).astype(np.int32),
        "d_users": rng.permutation(U)[:B].astype(np.int32),
        "d_weights": (np.arange(B) < 13).astype(np.float32),
        "d_t": np.stack([d[0] for d in d_draws]), "d_noise": np.stack([d[1] for d in d_draws]),
    }
    port = {
        "params": (gcn, dn, adam_state_from_jax(g_state), [adam_state_from_jax(s) for s in d_states]),
        "bufs": bufs, "draws": draws, "cl_noise": [n.numpy() for n in _cl_noise(key, 16)],
    }
    jax_side = {"steps": steps, "adj": adj, "modal_adjs": modal_adjs, "data": data, "gcn": gcn, "dn": dn,
                "g_state": g_state, "d_states": d_states, "key": key, "d_key": d_key, "hp": t_coach.hp()}
    return port, jax_side


@pytest.fixture(scope="module")
def setup():
    made = {form: _inputs(form, cl) for form, cl in FORMS.items()}
    inputs = {form: made[form][0] for form in FORMS}
    ranks = run_ranks(_rank_work, 2, (inputs,))
    return made, ranks


def _close(a, b, rtol, atol):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("form", list(FORMS))
def test_blocks_match_one_rank_and_ranks_agree(setup, form):
    """World size 2 against the port's world size 1, and rank 0 against
    rank 1 bit for bit."""
    made, ranks = setup
    port_in = made[form][0]
    one = _blocks(_coach(_config(form, FORMS[form])), port_in, None)
    two = ranks[0][f"blocks_{form}"]
    for key in ("joint_state", "diffusion_state"):
        for x, y in zip(two[key], ranks[1][f"blocks_{form}"][key], strict=True):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    _close(two["joint_state"], one["joint_state"], 1e-5, 1e-6)
    _close(two["diffusion_state"], one["diffusion_state"], 1e-5, 1e-6)
    # each rank's metrics are its part; the step's totals are their sum
    np.testing.assert_allclose(ranks[0][f"blocks_{form}"]["metrics"] + ranks[1][f"blocks_{form}"]["metrics"],
                               one["metrics"], rtol=1e-5, atol=1e-6)


def _j_place(form, js, mesh):
    """The JAX joint step's inputs on ``mesh``: the edges (sparse form) over
    the data axis, the rest replicated."""
    from diffmm_tpu.parallel.sharding import _shard_adj, replicate

    place = (lambda a: _shard_adj(a, mesh)) if form == "sparse" else (lambda a: replicate(a, mesh))
    return place(js["adj"]), tuple(place(a) for a in js["modal_adjs"])


@pytest.mark.parametrize("form", list(FORMS))
def test_joint_block_matches_jax_mesh(setup, form):
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.parallel import make_mesh, shard_batch
    from diffmm_tpu.parallel.sharding import replicate
    from diffmm_tpu_torch.train.optim import tree_leaves

    made, ranks = setup
    port_in, js = made[form]
    mesh = make_mesh(2, model_parallel=1)
    adj, modal_adjs = _j_place(form, js, mesh)
    d = port_in["draws"]
    j_params, _, j_metrics = js["steps"].joint_step(
        replicate(js["gcn"], mesh), replicate(js["g_state"], mesh), adj, modal_adjs,
        replicate(js["data"].raw_feats, mesh), *(shard_batch(jnp.asarray(d[k]), mesh) for k in ("users", "pos", "neg")),
        js["key"], jnp.float32(LR), {k: jnp.float32(v) for k, v in js["hp"].items()},
    )
    tol = dict(rtol=1e-4, atol=1e-5) if form == "sparse" else dict(rtol=1e-2, atol=1e-3)
    metrics = ranks[0][f"blocks_{form}"]["metrics"] + ranks[1][f"blocks_{form}"]["metrics"]
    np.testing.assert_allclose(metrics, np.asarray(j_metrics), **tol)
    n = len(tree_leaves(js["gcn"]))
    _close(ranks[0][f"blocks_{form}"]["joint_state"][:n],
           [np.asarray(x) for x in jax.tree_util.tree_leaves(j_params)], tol["rtol"], tol["atol"])


def test_diffusion_block_matches_jax_mesh(setup):
    """The diffusion step on the CSR store (the sparse form's) against the
    JAX step with its user block over a (2, 1) mesh's data axis."""
    import jax
    import jax.numpy as jnp

    from diffmm_tpu.parallel import make_mesh, shard_batch
    from diffmm_tpu.parallel.sharding import replicate
    from diffmm_tpu_torch.train.optim import tree_leaves
    from test_torch_train_diffusion import _setup

    made, ranks = setup
    port_in, js = made["sparse"]
    _, j_data, j_steps = _setup("sparse")
    mesh = make_mesh(2, model_parallel=1)
    d = port_in["draws"]
    j_dn, _, j_losses = j_steps.diffusion_step(
        replicate(js["dn"], mesh), replicate(js["d_states"], mesh), replicate(js["gcn"], mesh),
        replicate(j_data.raw_feats, mesh), replicate(j_data.train_store, mesh),
        shard_batch(jnp.asarray(d["d_users"]), mesh), shard_batch(jnp.asarray(d["d_weights"]), mesh),
        js["d_key"], jnp.float32(LR), {k: jnp.float32(v) for k, v in js["hp"].items()},
    )
    two = ranks[0]["blocks_sparse"]
    np.testing.assert_allclose(two["losses"], np.asarray(j_losses), rtol=2e-4, atol=1e-5)
    n_gcn = len(tree_leaves(js["gcn"]))
    n_dn = sum(len(tree_leaves(p)) for p in js["dn"])
    _close(two["diffusion_state"][n_gcn:n_gcn + n_dn],
           [np.asarray(x) for p in j_dn for x in jax.tree_util.tree_leaves(p)], 1e-4, 1e-5)


@pytest.mark.parametrize("form", list(FORMS))
def test_epoch_and_eval_match_one_rank(setup, form):
    """train_epoch(0) + test_epoch at world size 2 against the port's
    single-device Coach (tests/test_parallel.py:58-79's tolerance), and the
    ranks' whole state bitwise equal after the epoch."""
    _, ranks = setup
    one = _epoch(_coach(_config(form, FORMS[form])))
    two = ranks[0][f"epoch_{form}"]
    for kind in ("train", "eval"):
        assert set(two[kind]) == set(one[kind])
        for k in one[kind]:
            assert two[kind][k] == pytest.approx(one[kind][k], rel=2e-3, abs=1e-5), (kind, k)
        assert ranks[1][f"epoch_{form}"][kind] == two[kind]
    for x, y in zip(two["state"], ranks[1][f"epoch_{form}"]["state"], strict=True):
        np.testing.assert_array_equal(x, y)


def test_batch_guard_and_model_axis_refusal(setup):
    _, ranks = setup
    errors = ranks[0]["errors"]
    assert errors["batch"][0] == "ValueError" and "divisible by the data-axis size 2" in errors["batch"][1]
    assert errors["a7b"][0] == "NotImplementedError" and "A7b" in errors["a7b"][1]


def test_fused_chunk_and_checkpoint_on_the_mesh(setup):
    """``train_epochs_fused`` at world size 2 equals two single epochs
    (losses, evals, state) exactly, as tests/test_torch_fused.py holds on
    one device; a checkpoint written by rank 0 restores the same state on
    every rank."""
    _, ranks = setup
    for out in ranks:
        f = out["fused"]
        assert f["results"] == [f["single"][0], f["single"][2]]
        assert f["evals"] == [f["single"][1], f["single"][3]]
        for x, y in zip(f["state"], f["single_state"], strict=True):
            np.testing.assert_array_equal(x, y)
        got, want, files = out["restored"]
        assert files == ["ckpt_00000000.pt"]
        for x, y in zip(got, want, strict=True):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(ranks[0]["restored"][0], ranks[1]["restored"][0], strict=True):
        np.testing.assert_array_equal(x, y)
