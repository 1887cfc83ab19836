"""mfu.train: the whole training epoch's share of the card's peak.

The operations one epoch needs, counted from the configuration's shapes and
the data's edge counts, whatever kernels compute them: the denoisers'
forward and backward in diffusion training, the rebuild's forward, the
joint step's feature projections (forward and weight gradient),
propagations (two directions, 2·nnz·d each, forward and backward) and
InfoNCE products, and the eval's forward and scoring. Divided by
``train_epoch_s`` times the TF32 rate, the card's fastest for the f32
operands of this program."""

import math

from benchmark.harness.peaks import TF32_FLOPS


def epoch_flops(s: dict) -> float:
    users, items, nnz, d, batch = s["users"], s["items"], s["nnz"], s["latdim"], s["batch"]
    m, f = len(s["feat_dims"]), sum(s["feat_dims"])
    (hidden,) = s["hidden"][:1]
    # diffusion: per real row and modality, layer 1 forward and weight
    # gradient (x_t needs no gradient: 4·I·H), layer 2 forward, weight and
    # input gradients (6·I·H); the similarity term's x0_hat @ feats forward
    # and input gradient, and x0 @ item embeddings forward (neither table
    # takes a gradient here: 6·I·d)
    diffusion = users * m * (10.0 * items * hidden + 6.0 * items * d)
    rebuild = users * m * s["steps"] * 4.0 * items * hidden
    props = m + 4  # modal graphs, the ID and fused hops, two CL layers
    nce = 2 + (m * (m - 1) if s["cl_method"] == 1 else 2 * m)
    joint_block = 4.0 * items * f * d + 2 * props * 4.0 * nnz * d + nce * 6.0 * batch * batch * d
    joint = math.ceil(nnz / batch) * joint_block
    evals = 1.0 / s["tst_epoch"]
    eval_flops = evals * (2.0 * items * f * d + (m + 2) * 4.0 * nnz * d + 2.0 * users * items * d)
    return diffusion + rebuild + joint + eval_flops


def read(layer: dict):
    shape, epoch_s = layer.get("shape"), layer.get("train_epoch_s")
    if layer.get("kind") != "train" or shape is None or not epoch_s:
        return None
    return 100.0 * epoch_flops(shape) / (epoch_s * TF32_FLOPS)
