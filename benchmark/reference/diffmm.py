"""Plain PyTorch DiffMM: the reference that the training cells are held to.

A straightforward implementation of the trainer's epoch (negative sampling,
diffusion training, graph rebuild by reverse diffusion, joint GCN training
with BPR, L2 and the two InfoNCE terms, Adam with the cosine learning rate)
and of its full-catalog eval, written from the model's equations (the DiffMM
paper and its reference code, ``Main.py`` and ``Model.py``), in float32 with
TF32 off, with ``torch.sparse`` products for the graphs and autograd for
every gradient. It imports nothing of the program: it recomputes the
normalised graphs, the train membership and the rebuilt graphs from the
inputs the benchmark made.

Random draws. The trainer's draws are part of its function (which items are
negatives, which timesteps and noise a diffusion row gets, the CL noise), so
the reference takes them from the same two streams, seeded from the run's
seed: a ``torch.Generator`` on the device (parameter init, then per epoch
the negatives, each diffusion block's timesteps and noise per modality,
each joint block's six CL noise tables) and ``np.random.default_rng`` (per
epoch the user permutation, then the interaction permutation). The order
and the shapes of the draws are the trainer's contract; everything computed
from them is done here independently.

The dense graph form states bf16 messages with f32 sums (each propagation
rounds its input, and in the backward its cotangent, to bf16); the sparse
form f32 messages. ``tf32=True`` runs every float32 product in TF32 (the
control); ``fault="half"`` takes each block's losses over its first half
only (a planted fault).
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
NEG_ROUNDS = 8
EDGE_ALIGN = 256  # the edge arrays' sentinel padding (the negatives' draw width)


# ----------------------------------------------------------------- trees
def leaves(tree, prefix=""):
    """(name, tensor) pairs of a parameter tree, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key], f"{prefix}{key}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree) for x in leaves(sub, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# ----------------------------------------------------------------- graphs
class Graph:
    """The normalised bipartite operator ``D^-1/2 (A + I) D^-1/2`` of a 0/1
    (U, I) block given by its edges, as two CSR products (A and Aᵀ)."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, user_num: int, item_num: int, bf16: bool):
        rows, cols = rows.long(), cols.long()
        dev = rows.device
        ones = torch.ones(rows.shape[0], dtype=torch.float32, device=dev)
        self.s_user = torch.rsqrt(torch.zeros(user_num, device=dev).index_add_(0, rows, ones) + 1.0)
        self.s_item = torch.rsqrt(torch.zeros(item_num, device=dev).index_add_(0, cols, ones) + 1.0)
        self.a = _csr(rows, cols, user_num, item_num)
        self.at = _csr(cols, rows, item_num, user_num)
        self.bf16 = bf16

    def prop(self, x_user: torch.Tensor, x_item: torch.Tensor):
        z_u = x_user * self.s_user[:, None]
        z_i = x_item * self.s_item[:, None]
        m_u, m_i = _Prop.apply(z_u, z_i, self)
        return self.s_user[:, None] * (m_u + z_u), self.s_item[:, None] * (m_i + z_i)


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int, n_cols: int) -> torch.Tensor:
    """The 0/1 (n_rows, n_cols) matrix of the (unique) edges, as CSR."""
    order = torch.argsort(rows * n_cols + cols)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows), 0)
    ones = torch.ones(rows.shape[0], dtype=torch.float32, device=rows.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(crow, cols[order], ones, (n_rows, n_cols))


def _msg(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


class _Prop(torch.autograd.Function):
    """(A z_i, Aᵀ z_u) with the messages in the graph form's type."""

    @staticmethod
    def forward(ctx, z_u, z_i, g):
        ctx.g = g
        return g.a @ _msg(z_i, g.bf16), g.at @ _msg(z_u, g.bf16)

    @staticmethod
    def backward(ctx, d_u, d_i):
        g = ctx.g
        return g.a @ _msg(d_i.contiguous(), g.bf16), g.at @ _msg(d_u.contiguous(), g.bf16), None


# ----------------------------------------------------------------- pieces
def l2n(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


def info_nce(v1, v2, idx, temp):
    """In-batch InfoNCE over the rows ``idx`` of two views."""
    logp = torch.log_softmax(l2n(v1[idx]) @ l2n(v2[idx]).T / temp, dim=1)
    return -torch.mean(torch.diagonal(logp))


def schedule(noise_scale, noise_min, noise_max, steps):
    """The diffusion buffers in float64, as f32 (reference ``Model.py:239-275``)."""
    var = np.linspace(noise_scale * noise_min, noise_scale * noise_max, steps, dtype=np.float64)
    ab = 1.0 - var
    betas = np.array([1.0 - ab[0]] + [min(1.0 - ab[i] / ab[i - 1], 0.999) for i in range(1, steps)])
    betas[0] = 1e-4
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    return {
        "acp": acp.astype(np.float32),
        "sqrt_acp": np.sqrt(acp).astype(np.float32),
        "sqrt_1macp": np.sqrt(1.0 - acp).astype(np.float32),
        "c1": (betas * np.sqrt(acp_prev) / (1.0 - acp)).astype(np.float32),
        "c2": ((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)).astype(np.float32),
    }


def bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count), dtype=np.float32))


def cosine_lr(epoch, base, total, eta_min=1e-4):
    if total <= 0:
        return base
    return eta_min + (base - eta_min) * (1 + math.cos(math.pi * epoch / total)) / 2


class Adam:
    def __init__(self, tree):
        self.params = [p for _, p in leaves(tree)]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr):
        self.count += 1
        lr = float(np.float32(lr))
        bc1, bc2 = bias_correction(B1, self.count), bias_correction(B2, self.count)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))


# ----------------------------------------------------------------- model
class Reference:
    """DiffMM trained from ``seed`` on the benchmark's inputs.

    ``spec`` is a configuration's ``program`` section (its ``base``,
    ``hyper`` and ``train`` settings); ``inputs`` the benchmark's
    :class:`~benchmark.harness.data.Inputs`."""

    def __init__(self, spec: dict, inputs, seed: int, device, tf32: bool = False, fault: str | None = None):
        self.base, self.hyper, self.train = spec["base"], spec["hyper"], spec["train"]
        self.dev = torch.device(device)
        self.tf32 = tf32
        self.fault = fault
        self.U, self.I = inputs.user_num, inputs.item_num
        self.nnz = inputs.nnz
        self.M = len(inputs.feat_dims)
        self.B = int(self.train["batch"])
        self.feats = inputs.feats
        self.degrees = torch.as_tensor(inputs.degrees, device=self.dev).long()
        self.rows = torch.as_tensor(inputs.rows, device=self.dev).long()
        self.cols = torch.as_tensor(inputs.cols, device=self.dev).long()
        self.offsets = torch.as_tensor(inputs.offsets, device=self.dev).long()
        self.k_max = int(inputs.degrees.max())
        self.train_keys = torch.sort(self.rows * self.I + self.cols).values
        self.bf16 = self.train["graph_form"] == "dense"
        self.graph = Graph(self.rows, self.cols, self.U, self.I, self.bf16)
        self.test_items = torch.as_tensor(inputs.test_items, device=self.dev).long()
        self.sched = {k: torch.as_tensor(v, device=self.dev) for k, v in schedule(
            self.hyper["noise_scale"], self.hyper["noise_min"], self.hyper["noise_max"],
            self.hyper["steps"]).items()}
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        with self.precision():
            self._init_params(inputs.feat_dims)
        self.gcn_opt = Adam(self.gcn)
        self.dn_opts = [Adam(p) for p in self.dn]
        self.modal_graphs = None
        self.edges = None

    @contextlib.contextmanager
    def precision(self):
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    # -------------------------------------------------------------- init
    def _uniform(self, shape, bound):
        return torch.rand(shape, generator=self.gen, device=self.dev) * (2 * bound) - bound

    def _init_params(self, feat_dims):
        d = int(self.base["latdim"])
        xav = lambda r, c: self._uniform((r, c), math.sqrt(6.0 / (r + c)))  # noqa: E731
        self.gcn = {"u_embs": xav(self.U, d), "i_embs": xav(self.I, d), "modal_proj": []}
        for f in feat_dims:
            w = self._uniform((f, d), 1.0 / math.sqrt(f))
            self.gcn["modal_proj"].append({"w": w, "b": self._uniform((d,), 1.0 / math.sqrt(f))})
        self.gcn["modal_weight"] = torch.full((self.M,), 1.0 / self.M if self.M == 3 else 0.5, device=self.dev)
        hidden = [int(h) for h in str(self.base["denoise_dim"]).strip("[]").split(",")]
        if len(hidden) != 1:
            raise ValueError("the reference's denoiser has one hidden layer")
        h, e = hidden[0], int(self.base["d_emb_size"])

        def layer(a, b):
            w = torch.randn((a, b), generator=self.gen, device=self.dev) * math.sqrt(2.0 / (a + b))
            return {"w": w, "b": torch.randn((b,), generator=self.gen, device=self.dev) * 0.001}

        self.dn = []
        for _ in range(self.M):
            p = {"in_layers": [layer(self.I + e, h)], "out_layers": [layer(h, self.I)], "emb": layer(e, e)}
            p["gate"] = {"w": self._uniform((d, d), 1.0 / math.sqrt(d)), "b": self._uniform((d,), 1.0 / math.sqrt(d))}
            self.dn.append(p)

    # -------------------------------------------------------------- denoiser
    def denoise(self, p, x_t, t, feat=None):
        e = p["emb"]["w"].shape[0]
        half = e // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=self.dev) / half)
        ang = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        if e % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        temb = emb @ p["emb"]["w"] + p["emb"]["b"]
        if feat is not None:
            proj = x_t @ feat
            gate = torch.sigmoid(proj @ p["gate"]["w"] + p["gate"]["b"])
            x_t = x_t + (proj * gate) @ feat.T
        w1 = p["in_layers"][0]["w"]
        h = torch.tanh(x_t @ w1[: self.I] + temb @ w1[self.I:] + p["in_layers"][0]["b"])
        return h @ p["out_layers"][0]["w"] + p["out_layers"][0]["b"]

    def train_rows(self, users):
        """(B, I) 0/1 train rows of ``users``."""
        users = users.long()
        lanes = torch.arange(self.k_max, device=self.dev)
        valid = lanes[None, :] < self.degrees[users][:, None]
        pos = (self.offsets[users][:, None] + lanes[None, :]).clamp_max(self.nnz - 1)
        out = torch.zeros((users.shape[0], self.I), device=self.dev)
        r = torch.arange(users.shape[0], device=self.dev)[:, None].expand_as(pos)
        out[r[valid], self.cols[pos][valid]] = 1.0
        return out

    def is_train(self, users, items):
        keys = users.long() * self.I + items.long()
        at = torch.searchsorted(self.train_keys, keys).clamp_max(self.nnz - 1)
        return self.train_keys[at] == keys

    # -------------------------------------------------------------- model
    def project(self):
        return [f @ p["w"] + p["b"] for f, p in zip(self.feats, self.gcn["modal_proj"])]

    def forward(self, g, modal_graphs=None):
        """(u_final, i_final, modal_u, modal_i, id_u, id_i) of params ``g``
        over ``modal_graphs`` (default: this model's rebuilt ones)."""
        hp = self.hyper
        modal_graphs = self.modal_graphs if modal_graphs is None else modal_graphs
        feats = [l2n(f, 1) for f in (fp @ p["w"] + p["b"] for fp, p in zip(self.feats, g["modal_proj"]))]
        modal = [mg.prop(g["u_embs"], f) for mg, f in zip(modal_graphs, feats)]
        id_u, id_i = self.graph.prop(g["u_embs"], g["i_embs"])
        w = torch.softmax(g["modal_weight"], dim=0)
        fu = sum(w[m] * (id_u + hp["modal_adj_weight"] * modal[m][0]) for m in range(self.M))
        fi = sum(w[m] * (id_i + hp["modal_adj_weight"] * modal[m][1]) for m in range(self.M))
        hu, hi = self.graph.prop(fu, fi)
        rw = hp["residual_weight"]
        return (1.0 + rw) * (fu + hu), (1.0 + rw) * (fi + hi), [m[0] for m in modal], [m[1] for m in modal], id_u, id_i

    # -------------------------------------------------------------- epoch
    def epoch(self, e: int) -> dict:
        """One training epoch; returns its loss dict, as the trainer's."""
        with self.precision():
            return self._epoch(e)

    def _blocks(self, n):
        nb = max(1, -(-n // self.B))
        idx = np.zeros(nb * self.B, dtype=np.int64)
        idx[:n] = np.arange(n)
        valid = np.zeros(nb * self.B, dtype=bool)
        valid[:n] = True
        return idx, valid, nb

    def _epoch(self, e):
        hp, tr = self.hyper, self.train
        lr = cosine_lr(e, tr["lr"], tr["epoch"]) if tr["use_lr_scheduler"] else tr["lr"]
        d_idx, d_valid, nb_d = self._blocks(self.U)
        j_idx, _, nb_j = self._blocks(self.nnz)
        user_perm = self.np_rng.permutation(self.U)
        d_users = torch.as_tensor(user_perm[d_idx % self.U].reshape(nb_d, self.B), device=self.dev)
        d_w = torch.as_tensor(d_valid.reshape(nb_d, self.B).astype(np.float32), device=self.dev)
        perm = torch.as_tensor(self.np_rng.permutation(self.nnz)[j_idx % self.nnz], device=self.dev)

        # negatives: rounds of uniform draws, redrawn where they hit a train item
        n_pad = self.nnz + (-self.nnz % EDGE_ALIGN)
        draws = torch.randint(0, self.I, (NEG_ROUNDS, n_pad), generator=self.gen, device=self.dev)[:, : self.nnz]
        negs = draws[0].clone()
        needs = self.is_train(self.rows, negs)
        for r in range(1, NEG_ROUNDS):
            negs = torch.where(needs, draws[r], negs)
            needs = needs & self.is_train(self.rows, negs)

        # diffusion training
        with torch.no_grad():
            feats = self.project()
        i_embs = self.gcn["i_embs"]
        acc = torch.zeros(self.M, device=self.dev)
        steps = int(hp["steps"])
        for j in range(nb_d):
            users, w = d_users[j], d_w[j]
            if self.fault == "half":
                w = w.clone()
                w[self.B // 2:] = 0.0
            x0 = self.train_rows(users)
            live = [opt.params for opt in self.dn_opts]
            for t in (t for p in live for t in p):
                t.requires_grad_(True)
            losses = []
            for m in range(self.M):
                t = torch.randint(0, steps, (self.B,), generator=self.gen, device=self.dev)
                noise = torch.randn((self.B, self.I), generator=self.gen, device=self.dev)
                losses.append(self._diffusion_loss(m, x0, t, noise, feats[m], i_embs, w))
            total = sum(losses)
            grads = torch.autograd.grad(total / total.detach(), [t for p in live for t in p])
            for t in (t for p in live for t in p):
                t.requires_grad_(False)
            at = 0
            for opt, p in zip(self.dn_opts, live):
                opt.step(grads[at:at + len(p)], lr)
                at += len(p)
            ls = torch.stack([x.detach() for x in losses])
            acc = (acc + ls) / torch.clamp_min(ls.sum(), 1e-12)

        # rebuild: reverse diffusion from the clean rows, top-degree items per user
        self.edges = self.rebuild()
        self.modal_graphs = [Graph(self.rows, c, self.U, self.I, self.bf16) for c in self.edges]

        # joint training
        jacc = torch.zeros(4, device=self.dev)
        users_all, pos_all, neg_all = self.rows[perm], self.cols[perm], negs[perm]
        for j in range(nb_j):
            sl = slice(j * self.B, (j + 1) * self.B)
            jacc += self._joint_block(users_all[sl], pos_all[sl], neg_all[sl], lr)
        jacc = jacc.cpu().numpy()
        acc = acc.cpu().numpy()
        n_train, n_diff = max(1, self.nnz // self.B), max(1, self.U // self.B)
        out = {"Loss": jacc[0] / n_train, "BPR Loss": jacc[1] / n_train, "reg loss": jacc[2] / n_train,
               "CL loss": jacc[3] / n_train}
        for m in range(self.M):
            out[f"modal{m} loss"] = acc[m] / n_diff
        return {k: float(v) for k, v in out.items()}

    def _diffusion_loss(self, m, x0, t, noise, feat, i_embs, w):
        hp, s = self.hyper, self.sched
        p = self.dn[m]
        x_t = s["sqrt_acp"][t][:, None] * x0 + s["sqrt_1macp"][t][:, None] * noise
        x0_hat = self.denoise(p, x_t, t, feat)
        mse = torch.sum(torch.square(x0_hat - x0), dim=-1) / self.I
        snr = lambda tt: s["acp"][tt] / (1.0 - s["acp"][tt] + 1e-8)  # noqa: E731
        weight = torch.where(t == 0, torch.ones_like(mse), snr(torch.clamp_min(t - 1, 0)) - snr(t))
        cos = torch.sum(l2n(x0_hat @ feat) * l2n(x0 @ i_embs), dim=-1)
        row = weight * mse + (1.0 - cos) * hp["sim_weight"] + self.train["reg"] * torch.sum(i_embs ** 2) * self.train["reg"]
        return torch.sum(row * w) / torch.clamp_min(w.sum(), 1.0)

    def denoised(self, p, users):
        """Reverse diffusion of ``users``' clean train rows by denoiser ``p``."""
        s = self.sched
        if int(self.hyper["sampling_step"]) != 0:
            raise ValueError("the reference rebuilds from the clean rows (sampling_step 0)")
        x = self.train_rows(users)
        for i in range(int(self.hyper["steps"]) - 1, -1, -1):
            t = torch.full((users.shape[0],), i, dtype=torch.long, device=self.dev)
            x = s["c1"][i] * self.denoise(p, x, t) + s["c2"][i] * x
        return x

    @torch.no_grad()
    def rebuild(self) -> list[torch.Tensor]:
        """Per modality, (nnz,) items: each user's top-degree items of its
        reverse-diffused train row, in the edges' user-major order."""
        lanes = torch.arange(self.k_max, device=self.dev)
        out = []
        for p in self.dn:
            tables = []
            for lo in range(0, self.U, self.B):
                users = torch.arange(lo, min(lo + self.B, self.U), device=self.dev)
                tables.append(torch.topk(self.denoised(p, users), self.k_max, dim=1).indices)
            table = torch.cat(tables)
            out.append(table[lanes[None, :] < self.degrees[:, None]])
        return out

    @torch.no_grad()
    def rebuild_gap(self, dn: list, edges: list) -> float:
        """How far a rebuild's picks (``edges``, per modality, user-major)
        lie below each user's top-degree items when ``dn``'s denoisers
        reverse-diffuse the user's row here: the widest gap between the
        user's degree-th best score and the lowest score of its picks, over
        the row's range. Exact top-k reads 0; a pick outside the catalog,
        or the same item twice, reads inf."""
        worst = 0.0
        with self.precision():
            for p, picks in zip(dn, edges):
                picks = torch.as_tensor(picks, device=self.dev).long()
                if bool(((picks < 0) | (picks >= self.I)).any()):
                    return float("inf")
                for lo in range(0, self.U, self.B):
                    users = torch.arange(lo, min(lo + self.B, self.U), device=self.dev)
                    x = self.denoised(p, users)
                    a, b = int(self.offsets[lo]), int(self.offsets[users[-1]] + self.degrees[users[-1]])
                    rows = self.rows[a:b] - lo
                    got = x[rows, picks[a:b]]
                    flat = torch.unique(rows * self.I + picks[a:b])
                    if flat.numel() != b - a:
                        return float("inf")
                    srt = torch.sort(x, dim=1, descending=True).values
                    kth = srt.gather(1, (self.degrees[users] - 1)[:, None])[:, 0]
                    low = torch.full_like(kth, float("inf")).scatter_reduce(0, rows, got, "amin")
                    span = (srt[:, 0] - srt[:, -1]).clamp_min(1e-30)
                    worst = max(worst, float(((kth - low) / span).max()))
        return worst

    def _joint_block(self, users, pos, neg, lr):
        hp = self.hyper
        if self.fault == "half":
            users, pos, neg = users[: self.B // 2], pos[: self.B // 2], neg[: self.B // 2]
        live = self.gcn_opt.params
        for t in live:
            t.requires_grad_(True)
        u_f, i_f, mod_u, mod_i, id_u, id_i = self.forward(self.gcn)
        ue, pe, ne = u_f[users], i_f[pos], i_f[neg]
        rec = -torch.mean(torch.log(1e-5 + torch.sigmoid((ue * pe).sum(1) - (ue * ne).sum(1))))
        reg = self.train["reg"] * (torch.sum(self.gcn["u_embs"] ** 2) + torch.sum(self.gcn["i_embs"] ** 2))
        ju, ji = id_u, id_i
        acc_u = acc_i = l0_u = l0_i = None
        nd = hp["noise_degree"]
        for k in range(3):
            if k > 0:
                ju, ji = self.graph.prop(ju, ji)
            nu_ = torch.rand(ju.shape, generator=self.gen, device=self.dev)
            ni_ = torch.rand(ji.shape, generator=self.gen, device=self.dev)
            ju = ju + torch.sign(ju) * l2n(nu_, 1) * nd
            ji = ji + torch.sign(ji) * l2n(ni_, 1) * nd
            if k == 0:
                acc_u, acc_i, l0_u, l0_i = ju, ji, ju, ji
            else:
                acc_u, acc_i = acc_u + ju, acc_i + ji
        tc = hp["cross_cl_temp"]
        cl = (info_nce(acc_u / 3.0, l0_u, users, tc) + info_nce(acc_i / 3.0, l0_i, pos, tc)) * hp["cross_cl_rate"]
        tm, rm = hp["modal_cl_temp"], hp["modal_cl_rate"]
        if int(self.base["cl_method"]) == 1:
            for a in range(self.M):
                for b in range(a + 1, self.M):
                    cl = cl + (info_nce(mod_u[a], mod_u[b], users, tm)
                               + info_nce(mod_i[a], mod_i[b], pos, tm)) * rm
        else:
            for m in range(self.M):
                cl = cl + (info_nce(u_f, mod_u[m], users, tm) + info_nce(i_f, mod_i[m], pos, tm)) * rm
        total = rec + reg + cl
        grads = torch.autograd.grad(total, live)
        for t in live:
            t.requires_grad_(False)
        self.gcn_opt.step(grads, lr)
        return torch.stack([total, rec, reg, cl]).detach()

    # -------------------------------------------------------------- eval
    def graphs_of(self, edges: list) -> list:
        """The modality graphs of rebuilt ``edges`` (per modality, user-major)."""
        return [Graph(self.rows, torch.as_tensor(c, device=self.dev).long(), self.U, self.I, self.bf16)
                for c in edges]

    @torch.no_grad()
    def final_embeddings(self, gcn=None, modal_graphs=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The (user, item) embeddings that the eval ranks, of this model or
        of the given GCN parameters and modality graphs."""
        with self.precision():
            return tuple(self.forward(self.gcn if gcn is None else gcn, modal_graphs)[:2])

    @torch.no_grad()
    def evaluate(self, topk: int, test_batch: int, gcn=None, modal_graphs=None) -> tuple[float, float, float]:
        """(Recall, NDCG, Precision) sums over the test users (a user without
        test items adds nothing),
        of this model or of the given GCN parameters and modality graphs."""
        u_f, i_f = self.final_embeddings(gcn, modal_graphs)
        with self.precision():
            gains = 1.0 / torch.log2(torch.arange(topk, dtype=torch.float32, device=self.dev) + 2.0)
            ideal = torch.cat([torch.zeros(1, device=self.dev), torch.cumsum(gains.double(), 0).float()])
            sums = torch.zeros(3, dtype=torch.float64, device=self.dev)
            for lo in range(0, self.U, test_batch):
                users = torch.arange(lo, min(lo + test_batch, self.U), device=self.dev)
                mask = self.train_rows(users)
                scores = (u_f[users] @ i_f.T) * (1.0 - mask) - mask * 1e8
                top = torch.topk(scores, topk, dim=1).indices
                t_items = self.test_items[users]
                match = (t_items[:, :, None] == top[:, None, :]) & (t_items[:, :, None] >= 0)
                hits = match.any(2).sum(1).float()
                counts = (t_items >= 0).sum(1)
                dcg = (match.float() * gains[None, None, :]).sum((1, 2))
                sums += torch.stack([(hits / counts.clamp_min(1)).sum(),
                                     (dcg / ideal[counts.clamp_max(topk)].clamp_min(1e-12)).sum(),
                                     (hits / topk).sum()]).double()
            return tuple(float(x) for x in sums.cpu())
