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
(``trace.json``).

Several cards (JAX ``cli.py:38-133``): ``--distributed`` joins the process
group that ``torchrun`` describes in the environment (the counterpart of
``jax.distributed.initialize``; NCCL on the cards, gloo with ``--device
cpu``), and ``--mesh DATAxMODEL`` lays the ranks out as a ``(data, model)``
mesh (``parallel/mesh.py``); D·M must be the world size, and without
``--distributed`` only ``--mesh 1x1`` runs (one process, a group of one).
``--distributed`` alone is a ``WORLDx1`` mesh. A model axis above 1 splits
the catalog-wide state (``i_embs``, the denoisers' wide layers, their Adam
moments and the dense blocks) over its ranks (``train/coach.py``). Every
rank trains; rank 0 alone logs, writes the checkpoints (whole arrays, which
restore into any mesh) and ``--export-index``.

    torchrun --nproc_per_node 2 -m diffmm_tpu_torch --mesh 2x1 --distributed
    torchrun --nproc_per_node 2 -m diffmm_tpu_torch --mesh 1x2 --distributed
    torchrun --nproc_per_node 2 -m diffmm_tpu_torch --device cpu --mesh 1x2 --distributed
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch.distributed as dist

from diffmm_tpu_torch.config import apply_overrides, load_config
from diffmm_tpu_torch.data.loader import load_host_data
from diffmm_tpu_torch.utils.device import resolve_device
from diffmm_tpu_torch.utils.logging import Log, NullLog


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
    parser.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                        help="lay the ranks out as a (data, model) mesh, e.g. 2x1 or 1x2; D*M must "
                        "be the world size (the model axis splits the catalog-wide state)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group torchrun describes (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); NCCL, or gloo with --device cpu")
    args = parser.parse_args(argv)

    mesh = None
    if args.mesh or args.distributed:
        mesh = _mesh(parser, args)
    rank0 = mesh is None or dist.get_rank() == 0
    device = resolve_device(args.device)

    try:
        config = load_config(args.config)
        if rank0:
            print(f"Load configuration ({config.data.name}) file successfully👌")
    except Exception as e:  # reference Main.py:463-468
        print(f"Error loading configuration file: {e}")
        return 1
    if args.set:
        try:
            apply_overrides(config, args.set)
        except ValueError as e:
            parser.error(str(e))

    log = Log("main", config.data.name) if rank0 else NullLog()
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

    if mesh is not None:
        log.info(f"Mesh: {args.mesh or f'{dist.get_world_size()}x1'} over {dist.get_world_size()} ranks")
    coach = Coach(config, host, device=device, log=log, checkpoint_dir=args.checkpoint_dir,
                  checkpoint_every=args.checkpoint_every, mesh=mesh)
    with trace(args.trace_dir if rank0 else None):
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

            # every rank runs the forward (its collectives need them all);
            # rank 0 writes the whole index, not its catalog rows
            index = build_index(coach, place=False)
            if rank0:
                save_index(index, args.export_index)
            which = (f"best epoch {coach.best_snapshot['epoch']}"
                     if coach.best_snapshot is not None else "final epoch")
            log.info(f"Serving index ({which}) saved to {args.export_index} 📦")
    return 0


def _mesh(parser, args):
    """The process group and the mesh of ``--mesh``/``--distributed``."""
    from diffmm_tpu_torch.parallel.mesh import init_distributed, make_mesh

    data, model = None, 1
    if args.mesh:
        try:
            data, model = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            parser.error(f"--mesh takes DATAxMODEL, e.g. 2x1, got {args.mesh!r}")
        if data < 1 or model < 1:
            parser.error(f"--mesh {args.mesh}: both sizes must be at least 1")
        if data * model > 1 and not args.distributed:
            parser.error(f"--mesh {args.mesh} spans {data * model} ranks: run it under torchrun "
                         "with --distributed (only --mesh 1x1 runs in one process)")
    if args.distributed and "WORLD_SIZE" not in os.environ:
        parser.error("--distributed joins the group its launcher describes, and none is set "
                     "(torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    init_distributed("gloo" if args.device == "cpu" else "nccl")
    world = dist.get_world_size()
    if data is not None and data * model != world:
        parser.error(f"--mesh {args.mesh} needs {data * model} ranks, the group has {world}")
    return make_mesh(world, model_parallel=model)


if __name__ == "__main__":
    from diffmm_tpu_torch.parallel.mesh import shutdown_distributed

    try:
        code = main()
    finally:
        shutdown_distributed()
    raise SystemExit(code)
