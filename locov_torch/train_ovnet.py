"""Training/eval CLI of the PyTorch port, the twin of the repository's
``train_ovnet.py`` (the reference surface, train_ovnet.py:96-107):

    python -m locov_torch.train_ovnet --config-file configs/coco_lsm.yaml \\
        [--eval-only] [--resume] [--device cpu] [KEY VALUE ...]

The same arguments and ``verify_results``; ``config.yaml`` goes to
OUTPUT_DIR. ``--device`` picks the device: the card unless ``cpu`` is
given (no GPU and no ``--device cpu`` raises; there is no fallback).
One process drives one device. ``--num-gpus N`` starts N ranks on this
machine with ``torch.multiprocessing.spawn`` (the reference's d2
``launch``), rank ``machine_rank * N + i`` on ``cuda:<i>`` (NCCL) or,
under ``--device cpu``, on the CPU (gloo); ``--num-machines`` and
``--machine-rank`` count the machines, ``--dist-url`` is the first
machine's ``tcp://host:port`` (``auto``: a free local port, one machine
only). A world of one starts no process group. Rank 0 writes
``config.yaml`` and prints INFO logs; only a world of one returns the
results. ``TPU.COMPILE_CACHE_DIR`` is a setting of the JAX package and
is not read.
"""
import argparse
import logging
import os


def default_argument_parser():
    p = argparse.ArgumentParser(description="locov training (PyTorch)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--num-gpus", type=int, default=1,
                   help="ranks (devices) of this machine")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on "
                        "the CPU)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                   help="'KEY VALUE' config overrides")
    return p


def setup(args, rank: int = 0):
    from locov_torch.config import (add_ovr_config,
                                    edit_output_dir_exp_specific, get_cfg)
    cfg = get_cfg()
    add_ovr_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    # literal_eval of CLI opts (reference train_ovnet.py:49-56)
    cfg.merge_from_list(list(args.opts or []))
    cfg = edit_output_dir_exp_specific(cfg)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    if rank == 0:
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    return cfg


def main(args):
    world = args.num_gpus * args.num_machines
    if world > 1:
        import torch.multiprocessing as mp
        from locov_torch.parallel.mesh import local_url
        url = args.dist_url
        if url == "auto":
            if args.num_machines > 1:
                raise ValueError("--dist-url auto needs --num-machines 1")
            url = local_url()
        mp.spawn(_rank_main, args=(args, url, world), nprocs=args.num_gpus)
        return None
    return run(args)


def _rank_main(local_rank: int, args, url: str, world: int):
    """One spawned rank: its device, the process group, ``run``."""
    import torch
    import torch.distributed as dist
    from locov_torch.parallel.mesh import initialize_distributed
    rank = args.machine_rank * args.num_gpus + local_rank
    if args.device == "cpu":
        device, backend = "cpu", "gloo"
    else:
        device, backend = f"cuda:{local_rank}", "nccl"
        torch.cuda.set_device(local_rank)
    initialize_distributed(url, world, rank, backend)
    try:
        run(args, device, rank)
    finally:
        dist.destroy_process_group()


def run(args, device=None, rank: int = 0):
    """Set up, train or evaluate on ``device`` (``--device`` where not
    given) as ``rank``."""
    cfg = setup(args, rank)

    from locov_torch.data import get_register_dataset
    from locov_torch.engine.trainer import OVRTrainer

    for name in tuple(cfg.DATASETS.TRAIN) + tuple(cfg.DATASETS.TEST):
        get_register_dataset(name)(name, cfg.DATASETS.ROOT)

    trainer = OVRTrainer(cfg, device=device or args.device)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        try:
            results = trainer.test(cfg)
        finally:
            trainer.close()
        if cfg.TEST.EXPECTED_RESULTS and rank == 0:
            verify_results(cfg, results)
        return results
    return trainer.train()


def verify_results(cfg, results) -> bool:
    """d2 verify_results: check TEST.EXPECTED_RESULTS
    [[dataset, metric, expected, tolerance], ...]."""
    ok = True
    for dataset, metric, expected, tol in cfg.TEST.EXPECTED_RESULTS:
        actual = results.get(dataset, {}).get(metric)
        if actual is None or abs(actual - expected) > tol:
            print(f"FAIL: {dataset}/{metric}: {actual} vs "
                  f"{expected}±{tol}")
            ok = False
        else:
            print(f"OK: {dataset}/{metric}: {actual}")
    return ok


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    print("Command Line Args:", args)
    main(args)
