"""CLI entry point: `python -m sgnn_tpu_torch <config.cfg>`.

The port's counterpart of `python -m sgnn_tpu` (sgnn_tpu/__main__.py).
Reference: the `nts` binary (toolkits/main.cpp:44) — reads a KEY:VALUE
cfg, loads the graph, dispatches on ALGORITHM, trains, prints per-epoch
accuracy and phase timers.  Runs on the card; `--cpu` runs the kernels'
plain versions on the CPU instead (there is no other way to the CPU).

Exit codes, as the JAX CLI's: 0 on success; 1 when `--infer` finds no
checkpoint, when training diverges under `--checkpoint-dir` (the message
names the last good checkpoint), and when the cfg asks for a layout the
port does not run (a mixed data × graph group); 2 for bad arguments.
Under `--checkpoint-dir` the run's report covers the epochs this call
trained.

The *MULTI engines train data-parallel: on a one-rank group by default,
on N ranks under `torchrun --nproc-per-node N -m sgnn_tpu_torch cfg`
(one card a rank); rank 0 writes the checkpoints and the report.  Across
hosts, `--coordinator host:port --nprocs N --pid P` on every process
joins the N ranks through a TCP store at the coordinator
(parallel/multihost.py) and dispatches as the JAX CLI does: a *FULLBATCH
engine to the vertex-partitioned driver, an engine that samples on the
device to the device-sampled data-parallel one (SHARD_FEATURES honoured),
any other to the host-sampled one; it logs the final loss.  `--nprocs`
and `--pid` without `--coordinator` are ignored, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None) -> int:
    from .train.engines import ENGINES

    ap = argparse.ArgumentParser(
        prog="sgnn_tpu_torch",
        description="sample-based GNN training on one NVIDIA card",
        epilog="ALGORITHM strings: " + " ".join(sorted(ENGINES)))
    ap.add_argument("config", help="KEY:VALUE .cfg file (reference format)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save per-epoch checkpoints here (enables resume)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--algorithm", default=None,
                    help="override the cfg ALGORITHM string")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host training: the host:port of the TCP "
                         "store rank 0 hosts (launch one process a card "
                         "with --nprocs/--pid; reference MPI bootstrap, "
                         "dep/gemini/mpi.hpp:51)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="with --coordinator: the number of processes")
    ap.add_argument("--pid", type=int, default=None,
                    help="with --coordinator: this process's rank")
    ap.add_argument("--infer", metavar="CKPT_DIR", default=None,
                    help="pure serving: restore trained params from "
                         "CKPT_DIR (no training) and run exact whole-graph "
                         "inference; reports split accuracies")
    ap.add_argument("--predictions-out", metavar="NPY", default=None,
                    help="with --infer: write the [V, classes] log-prob "
                         "matrix to NPY (np.save format)")
    ap.add_argument("--exact-eval", action="store_true",
                    help="after training, report EXACT val/test accuracy "
                         "via whole-graph inference (no fanout sampling "
                         "noise; train/inference.py)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="record a torch.profiler trace of the run into "
                         "DIR/trace.json (Chrome trace format)")
    ap.add_argument("--report-out", metavar="JSON", default=None,
                    help="write the run's TrainReport (epoch times, "
                         "accuracies, phase timers) as JSON; "
                         "scripts/summarize_runs.py collects many into a "
                         "CSV")
    args = ap.parse_args(argv)

    from .config import load_cfg
    from .data.nts_format import load_from_config
    from .utils.logging import get_logger

    log = get_logger("sgnn.cli")
    cfg = load_cfg(args.config)
    if args.algorithm:
        cfg.algorithm = args.algorithm
    if args.epochs is not None:
        cfg.epochs = args.epochs
    log.info("ALGORITHM=%s layers=%s fanout=%s batch=%d epochs=%d on %s",
             cfg.algorithm, cfg.layer_sizes, cfg.fanout, cfg.batch_size,
             cfg.epochs, "cpu" if args.cpu else "cuda")
    ds = load_from_config(cfg)
    log.info("dataset: %s — %d vertices, %d edges", ds.name, ds.num_vertices,
             ds.num_edges)
    if args.profile:
        from .utils.profiling import trace

        prof_ctx = trace(args.profile)
    else:
        prof_ctx = contextlib.nullcontext()
    import torch.distributed as dist

    # a *MULTI engine joins a one-rank group, or torchrun's ranks
    # (parallel/mesh.make_group); the group this call made ends with it
    owns_group = not dist.is_initialized()
    try:
        with prof_ctx:
            return _run(args, cfg, ds, log, "cpu" if args.cpu else None)
    except NotImplementedError as exc:
        log.error("%s", exc)
        return 1
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, cfg, ds, log, device) -> int:
    from .train.engines import build_trainer, engine_from_config, run_engine
    from .train.inference import exact_accuracy, layerwise_inference

    spec = engine_from_config(cfg)
    if args.coordinator:
        return _run_multihost(args, cfg, ds, log, spec, device)
    if args.infer:
        # pure serving: restore params from a checkpoint and run exact
        # inference — the train→checkpoint→serve workflow
        from .train.checkpoint import CheckpointManager

        trainer = build_trainer(cfg, ds, device=device)
        ep = CheckpointManager(args.infer).restore(trainer)
        if ep is None:
            log.error("no checkpoint found in %s", args.infer)
            return 1
        log.info("restored epoch %d from %s", ep, args.infer)
        owner = getattr(trainer, "base", trainer)
        if spec.fullbatch:
            # *FULLBATCH checkpoints serve through the trainer's own
            # forward (its edge weights, AGGREGATOR, BATCH_NORM)
            logp = owner.predict()
        else:
            # sample-trained SAGE converges to the plain 1/indeg mean
            logp = layerwise_inference(
                owner.params, spec.family, owner.adj, ds.features,
                heads=cfg.heads, mean_style="plain",
                batch_norm=cfg.batch_norm, device=device)
        for split, nids in (("train", owner.train_nids),
                            ("val", owner.val_nids),
                            ("test", owner.test_nids)):
            if len(nids):
                acc = exact_accuracy(owner.params, spec.family, owner.adj,
                                     ds.features, ds.labels, nids, logp=logp,
                                     device=device)
                log.info("infer %s accuracy: %.4f", split, acc)
        if args.predictions_out:
            from .utils.io import save_npy

            save_npy(args.predictions_out, logp)
            log.info("wrote [%d, %d] log-probs to %s", logp.shape[0],
                     logp.shape[1], args.predictions_out)
        return 0
    if args.checkpoint_dir:
        # build the trainer the ALGORITHM string names and train with
        # per-epoch saves and optional resume
        from .train.checkpoint import run_with_checkpointing
        from .train.guard import DivergenceError

        trainer = build_trainer(cfg, ds, device=device)
        try:
            report = run_with_checkpointing(trainer, args.checkpoint_dir,
                                            cfg.epochs, resume=args.resume)
        except DivergenceError as exc:
            # the poisoned state was not saved; the message names the last
            # good checkpoint to resume from
            log.error("%s", exc)
            return 1
        if report.epoch_times:
            log.info("final (checkpointed): val %.4f test %.4f",
                     report.val_acc[-1], report.test_acc[-1])
    elif args.exact_eval:
        trainer = build_trainer(cfg, ds, device=device)
        report = trainer.run(epochs=cfg.epochs)
        owner = getattr(trainer, "base", trainer)
        if spec.fullbatch:
            # whole-graph training is full-neighborhood: evaluate with the
            # trainer's own forward
            va = trainer.evaluate(owner.val_nids)
            te = trainer.evaluate(owner.test_nids)
        else:
            logp = layerwise_inference(owner.params, spec.family, owner.adj,
                                       ds.features, heads=cfg.heads,
                                       batch_norm=cfg.batch_norm,
                                       device=device)
            va, te = (exact_accuracy(owner.params, spec.family, owner.adj,
                                     ds.features, ds.labels, nids, logp=logp,
                                     device=device)
                      for nids in (owner.val_nids, owner.test_nids))
        log.info("exact (full-neighborhood) eval: val %.4f test %.4f", va, te)
    else:
        report = run_engine(cfg, ds, device=device)
    # end-of-run summary (reference run() timer dump)
    log.info("avg epoch time: %.4fs", report.avg_epoch_time)
    log.info("phase timers: %s", report.timers.summary())
    if report.train_acc:
        log.info("final: train %.4f val %.4f test %.4f loss %.5f",
                 report.train_acc[-1], report.val_acc[-1],
                 report.test_acc[-1], report.losses[-1])
    if args.report_out and _rank() == 0:
        rec = {"config": args.config, "algorithm": cfg.algorithm,
               **report.to_dict()}
        with open(args.report_out, "w") as f:
            json.dump(rec, f, indent=1)
        log.info("wrote run report to %s", args.report_out)
    return 0


def _run_multihost(args, cfg, ds, log, spec, device) -> int:
    """Join the ranks at the coordinator and train with the driver the
    engine takes (sgnn_tpu/__main__.py:101-131)."""
    from .parallel.multihost import (
        initialize_distributed, run_multihost_device_dp_epochs,
        run_multihost_dp_epochs, run_multihost_fullbatch_epochs,
    )

    initialize_distributed(args.coordinator, args.nprocs, args.pid,
                           device=device)
    if spec.fullbatch:
        losses = run_multihost_fullbatch_epochs(
            cfg, ds, epochs=cfg.epochs, family=spec.family, halo=cfg.halo,
            weight_kind=spec.weight_kind, device=device)
    elif spec.device_sampling:
        losses = run_multihost_device_dp_epochs(
            cfg, ds, epochs=cfg.epochs, family=spec.family,
            shard_features=cfg.shard_features, device=device)
    else:
        losses = run_multihost_dp_epochs(cfg, ds, epochs=cfg.epochs,
                                         family=spec.family, device=device)
    log.info("multihost final loss: %.5f", losses[-1])
    return 0


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    sys.exit(main())
