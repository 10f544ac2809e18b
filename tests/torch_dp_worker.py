"""One rank of the data-parallel parity runs of
tests/test_torch_data_parallel.py, imported by the spawned processes
(no JAX here); no tests of its own.

``lsm_rank_worker`` joins a gloo process group, builds the tiny LSM
model (tests/torch_parity.py) with the weights and the config overrides
it is handed, and runs one step of ``make_train_step`` in each
contrastive scope from those same weights, on its rows of the batch with
the draws it is handed; it saves the parameters and the metrics after
each step.

``dynamic_rank_worker`` builds the tiny ``OvrRCNN`` in the dynamic int8
scheme and runs ``make_eval_step`` on its row of the batch (the scales
all-reduced over the ranks), then, through the evaluation loop's
``_in_lockstep``, over a loader of ``rank + 1`` copies of that row (a
rank whose shard is done runs idle passes); it saves the detections of
each step.

``calibrate_rank_worker`` builds the tiny ``OvrRCNN`` for the static
int8 scheme with the weights it is handed and runs one
``make_calibrate_step`` on its rows of the batch; it saves the max-abs
buffers. ``calibrate_shards_worker`` runs the trainer's
``maybe_calibrate_int8`` on a test loader of ``rank + 1`` batches (its
row of the batch repeated) and saves the passes it ran and the buffers.
"""
import torch


def lsm_rank_worker(rank, world, url, in_path, out_path):
    import torch.distributed as dist
    from locov_torch.config import config_path, get_cfg
    from locov_torch.engine.solver import build_optimizer
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import (initialize_distributed,
                                           make_train_step)
    from locov_torch.structures.batches import take_rows
    from torch_parity import tiny_lsm_cfg

    torch.set_num_threads(1)
    data = torch.load(in_path, weights_only=False)
    initialize_distributed(url, world, rank, "gloo")
    try:
        cfg = tiny_lsm_cfg(get_cfg, config_path, **data["extra"])
        b = data["batch"].images.image.shape[0] // world
        mine = take_rows(data["batch"], rank * b, (rank + 1) * b)
        out = {}
        for scope, uniforms in data["uniforms"].items():
            model = build_meta_arch(cfg, device="cpu")
            model.load_state_dict(data["weights"], strict=True)
            step = make_train_step(model, *build_optimizer(cfg, model),
                                   contrastive_scope=scope)
            metrics = step(mine, data["class_emb"], None, uniforms[rank])
            out[scope] = {
                "params": {k: v.detach().clone()
                           for k, v in model.named_parameters()},
                "metrics": {k: float(v) for k, v in metrics.items()}}
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def calibrate_rank_worker(rank, world, url, in_path, out_path):
    import torch.distributed as dist
    from locov_torch.config import get_cfg
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import (initialize_distributed,
                                           make_calibrate_step)
    from locov_torch.structures.batches import take_rows
    from torch_parity import tiny_cfg

    torch.set_num_threads(1)
    data = torch.load(in_path, weights_only=False)
    initialize_distributed(url, world, rank, "gloo")
    try:
        model = build_meta_arch(tiny_cfg(get_cfg, **data["extra"]),
                                device="cpu")
        model.load_state_dict(data["weights"], strict=True)
        b = data["batch"].images.image.shape[0] // world
        amax = make_calibrate_step(model)(
            take_rows(data["batch"], rank * b, (rank + 1) * b),
            data["class_emb"])
        torch.save({k: v.clone() for k, v in amax.items()}, out_path)
    finally:
        dist.destroy_process_group()


def calibrate_shards_worker(rank, world, url, in_path, out_path):
    import torch.distributed as dist
    from locov_torch.config import get_cfg
    from locov_torch.engine import trainer
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import initialize_distributed
    from locov_torch.structures.batches import take_rows
    from torch_parity import tiny_cfg

    class Loader(list):
        def close(self):
            pass

    torch.set_num_threads(1)
    data = torch.load(in_path, weights_only=False)
    initialize_distributed(url, world, rank, "gloo")
    try:
        cfg = tiny_cfg(get_cfg, **data["extra"])
        model = build_meta_arch(cfg, device="cpu")
        model.load_state_dict(data["weights"], strict=True)
        mine = take_rows(data["batch"], rank, rank + 1)
        trainer.build_test_loader = lambda *a, **k: Loader([mine] *
                                                           (rank + 1))
        passes = []
        calibrate = model.calibrate_int8
        model.calibrate_int8 = lambda *a: passes.append(1) or calibrate(*a)
        done = trainer.maybe_calibrate_int8(cfg, model, "any",
                                            data["class_emb"])
        torch.save({"done": done, "passes": len(passes),
                    "amax": {k: v.clone() for k, v in
                             model.amax_buffers().items()}}, out_path)
    finally:
        dist.destroy_process_group()


def dynamic_rank_worker(rank, world, url, in_path, out_path):
    import torch.distributed as dist
    from locov_torch.config import get_cfg
    from locov_torch.evaluation.evaluator import _in_lockstep
    from locov_torch.models import build_meta_arch
    from locov_torch.parallel.mesh import (initialize_distributed,
                                           make_eval_step)
    from locov_torch.structures.batches import take_rows
    from torch_parity import tiny_cfg

    torch.set_num_threads(1)
    data = torch.load(in_path, weights_only=False)
    initialize_distributed(url, world, rank, "gloo")
    try:
        model = build_meta_arch(tiny_cfg(get_cfg, **data["extra"]),
                                device="cpu")
        model.load_state_dict(data["weights"], strict=True)
        step = make_eval_step(model)
        ce = data["class_emb"]
        mine = take_rows(data["batch"], rank, rank + 1)
        half = [t.clone() for t in step(mine, ce)]
        lockstep = [[t.clone() for t in step(b, ce)]
                    for b in _in_lockstep([mine] * (rank + 1), step, ce)]
        torch.save({"half": half, "lockstep": lockstep}, out_path)
    finally:
        dist.destroy_process_group()
