"""Command-line entry point: ``python -m diffmm_tpu_torch -c conf/test.toml``.

Counterpart of ``diffmm_tpu/cli.py`` (reference `Main.py:459-487`): load
the config (``--set`` overrides), echo it, load the data, train with
``Coach.run`` and optionally export the best epoch's serving index. It runs
on the CUDA card; ``--device cpu`` runs the plain PyTorch versions of the
kernels on the CPU instead, and without a card and without that flag it
stops with an error. ``--checkpoint-dir`` saves the full training state
every ``--checkpoint-every`` epochs (10 by default, as the JAX CLI) and
after the last, and a run over a directory with checkpoints resumes from
the latest; ``--trace-dir`` writes a ``torch.profiler`` trace of the run
(``trace.json``). ``--mesh`` and ``--distributed`` belong to ROADMAP.md A7
(multi-device) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.loader import load_host_data
from diffmm_tpu_torch.utils.device import resolve_device
from diffmm_tpu_torch.utils.logging import Log


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="diffmm_tpu_torch trainer")
    parser.add_argument("--config", "-c", default="conf/test.toml", help="config file path")
    parser.add_argument("--data-root", default=None, help="dataset root directory")
    parser.add_argument("--epochs", type=int, default=None, help="override epoch count")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; needs a card) or cpu (plain PyTorch versions)")
    parser.add_argument("--eval-split", default="test", choices=("test", "val"),
                        help="ranking-eval split (val needs a shipped valMat.pkl)")
    parser.add_argument("--export-index", default=None, metavar="PATH",
                        help="after training, save the best epoch's serving index here")
    parser.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                        help="config override, e.g. --set hyper.noise_degree=1.0 (bare keys "
                        "default to [hyper]; repeatable, later wins)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="save and resume the full training state here (torch.save)")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="epochs between checkpoint saves (the last epoch always saves)")
    parser.add_argument("--trace-dir", default=None,
                        help="write a torch.profiler trace of the run here (trace.json)")
    parser.add_argument("--mesh", default=None, help="not ported yet (ROADMAP.md A7, slice 4)")
    parser.add_argument("--distributed", action="store_true",
                        help="not ported yet (ROADMAP.md A7, slice 4)")
    args = parser.parse_args(argv)

    for name in ("mesh", "distributed"):
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name} is not ported yet (ROADMAP.md A7: multi-device, slice 4)"
            )
    device = resolve_device(args.device)

    try:
        config = load_config(args.config)
        print(f"Load configuration ({config.data.name}) file successfully👌")
    except Exception as e:  # reference Main.py:463-468
        print(f"Error loading configuration file: {e}")
        return 1
    if args.set:
        try:
            apply_overrides(config, args.set)
        except ValueError as e:
            parser.error(str(e))

    log = Log("main", config.data.name)
    log.info("Start")
    log.info("Configuration Details:")
    for section_field in dataclasses.fields(config):
        section = getattr(config, section_field.name)
        log.info(f"[{section_field.name}]")
        for f in dataclasses.fields(section):
            log.info(f"  {f.name}: {getattr(section, f.name)}")

    log.info("Load Data")
    host = load_host_data(config, data_root=args.data_root)

    from diffmm_tpu_torch.train.coach import Coach
    from diffmm_tpu_torch.utils.profiling import trace

    coach = Coach(config, host, device=device, log=log, checkpoint_dir=args.checkpoint_dir,
                  checkpoint_every=args.checkpoint_every)
    with trace(args.trace_dir):
        best = coach.run(epochs=args.epochs, eval_split=args.eval_split)
    log.info(
        f"Best epoch: {best['best_epoch']}, Recall: {best['Recall']:.5f}, "
        f"NDCG: {best['NDCG']:.5f}, Precision: {best['Precision']:.5f}"
    )
    if args.export_index:
        if coach.modal_adjs is None and coach.best_snapshot is None:
            log.info("⚠️ no trained epoch completed — skipping --export-index "
                     "(the serving index needs the epoch's modality graphs)")
        else:
            from diffmm_tpu_torch.eval.serving import build_index, save_index

            save_index(build_index(coach), args.export_index)
            which = (f"best epoch {coach.best_snapshot['epoch']}"
                     if coach.best_snapshot is not None else "final epoch")
            log.info(f"Serving index ({which}) saved to {args.export_index} 📦")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
