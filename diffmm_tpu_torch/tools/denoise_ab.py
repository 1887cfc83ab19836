"""K2/K3 of one checkout against another's on the card: each kernel case's
time, the library call's beside it, and a digest of its output bits.

    python diffmm_tpu_torch/tools/denoise_ab.py --root . --out c1.json
    python diffmm_tpu_torch/tools/denoise_ab.py --root PARENT --out p1.json
    python diffmm_tpu_torch/tools/denoise_ab.py --compare c1.json p1.json p2.json c2.json

Run as a file, not with ``-m``: ``--root`` names the checkout whose
``diffmm_tpu_torch`` it imports (an unpacked ``git archive`` of another
commit, say), and each checkout builds its own kernels into its own
``_build/``. Only the entry points every revision has are called
(``denoise_layer1``, ``denoise_layer1_partial``, ``denoise_layer2`` on
weights from ``prepare_weight``), on inputs drawn on the card from one seed
a case, so two checkouts see the same inputs. The cases are the rebuild's
shapes: tiktok's and yelp's catalogs at hidden 1,024, the model axis's
shards of them (and the odd shard, 3,355, beside 3,356, whose rows are
16-byte aligned: x's 1-float loads against its 4-float ones), and the
web-scale configuration's (hidden 64). Times are
the median of 3 runs of ``--iters`` warm calls, CUDA events
(``tools/joint_profile.py``'s ``median_ms``), eager (``ms``: the wrapper's
host work included, as an eager caller pays it) and as replays of one
captured call (``graph_ms``: the device's time, as the rebuild's captured
blocks pay it); the library call the same. Compare runs of the two trees
made in turns in one call (c1, p1, p2, c2): ``--compare`` prints each
case's times side by side and whether every run gave the same bits. The
card is required: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys

# (name, entry, (B, K, N)): entry computes an (B, K) x (K, N) product
CASES = (
    ("k2_tanh_tiktok", "denoise_layer1", (1024, 6710, 1024)),
    ("k2_partial_tiktok", "denoise_layer1_partial", (1024, 6710, 1024)),
    ("k3_tiktok", "denoise_layer2", (1024, 1024, 6710)),
    ("k2_tanh_yelp", "denoise_layer1", (1024, 20000, 1024)),
    ("k2_partial_yelp", "denoise_layer1_partial", (1024, 20000, 1024)),
    ("k3_yelp", "denoise_layer2", (1024, 1024, 20000)),
    ("k2_partial_shard", "denoise_layer1_partial", (1024, 3355, 1024)),
    # the odd shard widened to a 16-byte row pitch: the 4-float loads of x
    ("k2_partial_shard_aligned", "denoise_layer1_partial", (1024, 3356, 1024)),
    ("k3_shard", "denoise_layer2", (1024, 1024, 3355)),
    ("k2_partial_yelp_shard", "denoise_layer1_partial", (1024, 10000, 1024)),
    ("k3_yelp_shard", "denoise_layer2", (1024, 1024, 10000)),
    ("k2_tanh_s", "denoise_layer1", (512, 100000, 64)),
    ("k2_partial_s", "denoise_layer1_partial", (512, 100000, 64)),
    ("k2_partial_s_shard", "denoise_layer1_partial", (128, 50000, 64)),
    ("k3_s", "denoise_layer2", (512, 64, 100000)),
    ("k3_s_shard", "denoise_layer2", (128, 64, 50000)),
)


def _digest(t) -> str:
    """The first 16 hex digits of the sha256 of ``t``'s bytes."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def run(root: str, iters: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from diffmm_tpu_torch.ops.kernels import denoise_mlp as dm
    from diffmm_tpu_torch.tools.joint_profile import graphed, median_ms
    from diffmm_tpu_torch.utils.device import describe, resolve_device

    dev = resolve_device(None)
    out = {"root": os.path.abspath(root), "package": os.path.dirname(dm.__file__), "card": describe(dev),
           "cases": {}}
    for seed, (name, entry, (B, K, N)) in enumerate(CASES):
        gen = torch.Generator(device=dev).manual_seed(1600 + seed)
        a = torch.randn((B, K), generator=gen, device=dev)
        if entry == "denoise_layer2":
            a = torch.tanh(a)
        w = torch.randn((K, N), generator=gen, device=dev) * math.sqrt(2.0 / (K + N))
        e = torch.randn((B, N) if entry == "denoise_layer1" else (N,), generator=gen, device=dev) * 0.01
        wp = dm.prepare_weight(w)
        if entry == "denoise_layer1":
            kern, lib = (lambda: dm.denoise_layer1(a, wp, e)), (lambda: torch.tanh(torch.addmm(e, a, w)))
        elif entry == "denoise_layer1_partial":
            kern, lib = (lambda: dm.denoise_layer1_partial(a, wp)), (lambda: torch.matmul(a, w))
        else:
            kern, lib = (lambda: dm.denoise_layer2(a, wp, e)), (lambda: torch.addmm(e, a, w))
        got = kern()
        rec = {"entry": entry, "shape": [B, K, N], "digest": _digest(got),
               "bitwise_across_launches": bool(torch.equal(got, kern())),
               "max_abs_err_vs_library": float((got - lib()).abs().max()),
               "form": dm.denoise_form(K) if hasattr(dm, "denoise_form") else "gemm",
               **{key: median_ms(f, dev, iters, 3) for key, f in (
                   ("ms", kern), ("library_ms", lib), ("graph_ms", graphed(kern, dev)),
                   ("library_graph_ms", graphed(lib, dev)))}}
        out["cases"][name] = rec
        print(f"[denoise_ab] {name}: {json.dumps(rec)}", file=sys.stderr)
        del a, w, e, wp, got
    return out


def compare(paths: list[str]) -> dict:
    runs = [json.load(open(p)) for p in paths]
    table = {}
    for name in runs[0]["cases"]:
        recs = [r["cases"][name] for r in runs]
        table[name] = {"same_bits": len({r["digest"] for r in recs}) == 1, "form": [r["form"] for r in recs],
                       **{key: [r[key] for r in recs] for key in ("ms", "library_ms", "graph_ms", "library_graph_ms")}}
    return {"runs": [{"file": p, "root": r["root"], "card": r["card"]} for p, r in zip(paths, runs)],
            "cases": table}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose diffmm_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="write the run's JSON here too")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--compare", nargs="+", default=None, metavar="RUN_JSON",
                    help="print earlier runs' times side by side and whether their bits agree")
    args = ap.parse_args(argv)
    result = compare(args.compare) if args.compare else run(args.root, args.iters)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
