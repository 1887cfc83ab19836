"""Hyperparameter sweep harness, counterpart of ``tools/sweep.py`` (the
script form of the reference's sampling-step sensitivity experiments,
`notebooks/visualization.ipynb` cells 1-2, and of the commented-out sweep
driver at reference `Main.py:491-521`). It writes the same JSON, which
``tools/plot_sweeps.py`` renders.

One Coach is reused across the values of a dynamic hyperparameter: each
value after the first starts from ``Coach.reset`` (the parameters, Adam
states and random streams of a new Coach), then trains. The phase steps
read the hyperparameters as Python floats when they are captured as CUDA
graphs, and ``reset`` drops every captured graph, so each value's steps
are captured again with its own value; ``train.lr`` reaches the steps as
device scalars made every epoch.

  python -m diffmm_tpu_torch.tools.sweep -c conf/tiktok.toml --param sampling_step \\
      --values 0,1,2,3,4 --epochs 60 --out sweep_results.json

Coordinate-descent mode: sweep several hypers in sequence, fixing each at
its best-Recall winner before moving to the next (one Coach throughout):

  python -m diffmm_tpu_torch.tools.sweep -c conf/tiktok.toml --epochs 300 \\
      --plan "residual_weight=0.2,0.35,0.5;cross_cl_rate=0.25,0.5,0.75" --out sweep_plan.json

Forked mode for structural knobs (diffusion schedule constants, step
counts, widths, feature-synthesis modes): each value runs in its own child
process, ``python -m diffmm_tpu_torch.tools.sweep --run-once``, one after
another on the same device; the parent touches no device. Params may be
section-qualified:

  python -m diffmm_tpu_torch.tools.sweep -c conf/tiktok.toml --forked \\
      --param hyper.noise_scale --values 0.1,0.5,1.0 --epochs 300

Everything runs on the card unless ``--device cpu`` is given (forked
children inherit it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from diffmm_tpu_torch.config import cast_field, load_config, resolve_field

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The hypers a reused Coach can sweep: the scalar hypers the phase steps
# read from the config when they run or are captured (Coach.hp), the seed
# (through Coach.reset(seed=)), and the LR and regularisation weight. Only
# structural knobs (cl_method, steps, denoise_dim, latdim, graph_form, ...)
# need a fresh process. The same set as the JAX tool's.
DYNAMIC_SAFE = {
    "sampling_step", "seed", "sim_weight", "noise_degree",
    "cross_cl_temp", "cross_cl_rate", "modal_cl_temp", "modal_cl_rate",
    "modal_adj_weight", "residual_weight",
    "train.lr", "train.reg",
}


def _is_dynamic_safe(config, param: str) -> bool:
    """Spelling-independent: 'hyper.sim_weight' == 'sim_weight' etc."""
    obj, key = _resolve(config, param)
    for name in (key, f"hyper.{key}", f"train.{key}", f"base.{key}"):
        if name in DYNAMIC_SAFE and _resolve(config, name) == (obj, key):
            return True
    return False


def _resolve(config, qual: str):
    """'hyper.steps' / 'base.latdim' / bare 'steps' (hyper by default; bare
    'seed' maps to base.seed) -> (section object, field name); raises
    SystemExit on unknown sections and fields."""
    try:
        return resolve_field(config, qual)
    except ValueError as e:
        raise SystemExit(str(e))


def _cast(caster: type, raw):
    """Cast a CLI string to a config field's type (bools parsed)."""
    try:
        return cast_field(caster, raw)
    except ValueError as e:
        raise SystemExit(str(e))


def _cast_values(config, param: str, raw: str) -> list:
    obj, key = _resolve(config, param)
    caster = type(getattr(obj, key))
    return [_cast(caster, v) for v in raw.split(",")]


def _sweep_one(coach, config, log, param, values, epochs, *, fresh: bool):
    """Run ``epochs`` for each value of ``param``; return the result rows.

    ``fresh``: reset before the first value too (a previous sweep leg
    already trained on this Coach).
    """
    rows = []
    for i, value in enumerate(values):
        obj, key = _resolve(config, param)
        if (obj, key) == _resolve(config, "seed"):
            # any spelling of the seed goes through reset(seed=): reset
            # re-initialises from config.base.seed, so a setattr after it
            # would train every value on the old seed
            coach.reset(seed=value)
        else:
            if i > 0 or fresh:
                coach.reset()
            setattr(obj, key, value)
        log.info(f"🔁 sweep {param} = {value}")
        best = coach.run(epochs=epochs)
        rows.append({param: value, **best})
        log.info(f"sweep {param}={value}: {best}")
    return rows


def _child_env() -> dict:
    """The environment of a forked child: this one, with the repository on
    ``PYTHONPATH`` so that ``-m diffmm_tpu_torch...`` resolves from any
    working directory."""
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", "-c", default="conf/tiktok.toml")
    parser.add_argument("--param", default="sampling_step", help="hyper.<param> to sweep")
    parser.add_argument("--values", default="0,1,2,3,4", help="comma-separated values")
    parser.add_argument("--plan", default=None,
                        help="coordinate descent: 'p1=v,v,...;p2=v,v,...': each param is fixed at "
                        "its best-Recall winner before the next is swept (overrides --param)")
    parser.add_argument("--forked", action="store_true",
                        help="run each value in its own child process: needed for structural knobs "
                        "(hyper.steps, hyper.noise_scale, base.latdim, data.missing_modalities, "
                        "train.batch, ...); dynamic hypers and train.lr/train.reg sweep on one "
                        "Coach without it; params may be section-qualified")
    parser.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                        help="config override applied after load (repeatable)")
    parser.add_argument("--run-once", action="store_true",
                        help="internal (forked children): train once with the given --set "
                        "overrides and write the best metrics to --out as JSON")
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--out", default="sweep_results.json")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (the default; needs a card) or cpu; forked children inherit it")
    args = parser.parse_args(argv)

    if args.forked and args.plan:
        raise SystemExit(
            "--plan is not supported with --forked (the plan's reused-Coach coordinate descent is "
            "exactly what forking avoids); run forked sweeps one param at a time and carry winners "
            "via --set"
        )

    config = load_config(args.config)
    for override in args.set:
        qual, _, raw = override.partition("=")
        obj, key = _resolve(config, qual)
        setattr(obj, key, _cast(type(getattr(obj, key)), raw))

    # Check the requested params before any device or data work: a
    # structural knob swept on a reused Coach would keep its old value (its
    # shapes and schedule are made once), so refuse it up front (forked
    # children build a Coach per value and may sweep anything).
    plan_legs = []
    if args.plan:
        for leg in args.plan.split(";"):
            param, _, raw = leg.partition("=")
            plan_legs.append((param.strip(), raw))
    if not args.forked and not args.run_once:
        for param in [p for p, _ in plan_legs] or [args.param]:
            if not _is_dynamic_safe(config, param):
                raise SystemExit(
                    f"--param {param} is a compile-time constant; sweeping it on a reused Coach "
                    f"would silently keep the old value. Use --forked (one child process per "
                    f"value; dynamic-safe params: {sorted(DYNAMIC_SAFE)})."
                )

    if args.forked and not args.run_once:
        return _forked(args, config)

    from diffmm_tpu_torch.data.loader import load_host_data
    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.logging import Log

    host = load_host_data(config, data_root=args.data_root)
    log = Log("sweep", config.data.name)
    coach = Coach(config, host, device=args.device, log=log)

    if args.run_once:
        best = coach.run(epochs=args.epochs)
        with open(args.out, "w") as fh:
            json.dump(best, fh)
        print(json.dumps(best))
        return 0

    if args.plan:
        legs = [(param, _cast_values(config, param, raw)) for param, raw in plan_legs]
        report = {"config": args.config, "plan": args.plan, "epochs": args.epochs, "set": args.set,
                  "legs": [], "incumbent": {}}
        for li, (param, values) in enumerate(legs):
            rows = _sweep_one(coach, config, log, param, values, args.epochs, fresh=li > 0)
            best = max(rows, key=lambda r: r["Recall"])
            # every leg fixes its best-Recall winner before the next, a seed
            # leg included (bare "seed" resolves to base.seed)
            obj, key = _resolve(config, param)
            setattr(obj, key, best[param])
            report["incumbent"][param] = best[param]
            report["legs"].append({"param": param, "results": rows, "winner": best})
            log.info(f"🏁 leg {param}: winner {best[param]} (Recall {best['Recall']:.5f})")
            with open(args.out, "w") as fh:  # survive interruption
                json.dump(report, fh, indent=2)
        print(json.dumps(report["incumbent"]))
        return 0

    values = _cast_values(config, args.param, args.values)
    results = []
    for i, value in enumerate(values):
        results.extend(_sweep_one(coach, config, log, args.param, [value], args.epochs, fresh=i > 0))
        # written after every value: a long sweep survives interruption; the
        # overrides go with it, so a rerun has the whole configuration
        with open(args.out, "w") as fh:
            json.dump({"config": args.config, "param": args.param, "epochs": args.epochs,
                       "set": args.set, "results": results}, fh, indent=2)
    print(json.dumps(results))
    return 0


def _forked(args, config) -> int:
    """The parent of a forked sweep: one ``--run-once`` child a value, one
    after another (they share the device); this process touches no
    device."""
    swept_field = _resolve(config, args.param)
    for override in args.set:
        if _resolve(config, override.partition("=")[0]) == swept_field:
            raise SystemExit(f"--set names the swept param {args.param!r}; drop the override "
                             "(the sweep supplies its values)")
    values = _cast_values(config, args.param, args.values)
    results = []
    for value in values:
        with tempfile.NamedTemporaryFile(mode="r", suffix=".json", delete=False) as tmp:
            child_out = tmp.name
        cmd = [sys.executable, "-m", "diffmm_tpu_torch.tools.sweep", "-c", args.config, "--run-once",
               "--epochs", str(args.epochs), "--out", child_out]
        for override in args.set:
            cmd += ["--set", override]
        # the swept value goes last: the child applies --set in order
        cmd += ["--set", f"{args.param}={value}"]
        if args.data_root:
            cmd += ["--data-root", args.data_root]
        if args.device:
            cmd += ["--device", args.device]
        print(f"🔁 forked sweep {args.param} = {value}", flush=True)
        proc = subprocess.run(cmd, env=_child_env())
        if proc.returncode != 0:
            print(f"child for {args.param}={value} failed (rc={proc.returncode})", file=sys.stderr)
            results.append({args.param: value, "error": proc.returncode})
        else:
            with open(child_out) as fh:
                results.append({args.param: value, **json.load(fh)})
        os.unlink(child_out)
        with open(args.out, "w") as fh:  # survive interruption
            json.dump({"config": args.config, "param": args.param, "epochs": args.epochs,
                       "forked": True, "set": args.set, "results": results}, fh, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
