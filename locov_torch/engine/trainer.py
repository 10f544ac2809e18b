"""OVRTrainer: build-everything orchestration + train loop + hooks, and
the evaluation side as module functions.

Counterpart of ``locov_tpu/engine/trainer.py`` (a behavioral port of
the reference trainer, ``ovr/engine/trainer.py:37-566``), one device a
rank of ``torch.distributed``.
The module functions: ``proposal_slots`` (:53), ``build_tokenizer``
(:68), the test loader (``OVRTrainer.build_test_loader``, :180-210),
the class-embedding matrix of a dataset (``OVRTrainer.load_embeddings``,
:212-228) and ``OVRTrainer.test`` (:510-545): the loss-only pass and the
detection pass of each test dataset. ``OVRTrainer`` builds the model,
optimizer and loaders and runs the custom loop with init-eval
(trainer.py:104-107), the hook schedule (timer, LR record, periodic
checkpointer max_to_keep=2, eval with best-metric save, periodic
writers, trainer.py:220-291), resume with the key-rename fan-out map for
the LSM->STT hand-off (trainer.py:293-363) and the NaN ->
FloatingPointError tripwire (trainer.py:554-559). Where
``torch.distributed`` runs several ranks (``train_ovnet --num-gpus``),
every rank builds the model, optimizer and generators, trains on its
shard of each batch (the gradients averaged over the ranks in the
step, ``TPU.CONTRASTIVE_SCOPE`` local or global) and evaluates its
shard; rank 0 alone writes checkpoints, metrics and the best-metric
side file. The eval batch is not rounded to a device count (one device
a rank).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import auto_scale_workers
from ..data import DatasetCatalog, MetadataCatalog, get_register_dataset
from ..data.loader import (DataLoader, InferenceSampler, TrainingSampler,
                           derive_buckets)
from ..data.mappers import DetectionMapper
from ..data.tokenization import WordPieceTokenizer, build_tiny_vocab
from ..evaluation.evaluator import (inference_on_caption_dataset,
                                    inference_on_detection_dataset,
                                    select_evaluator_type)
from ..models import build_meta_arch
from ..parallel.mesh import (DevicePrefetcher, make_calibrate_step,
                             make_eval_step, make_loss_eval_step,
                             make_train_step, process_rank_world)
from ..structures.batches import to_torch
from ..utils.checkpoint import (STT_FROM_LSM_RENAME, Checkpointer,
                                load_weights_standalone,
                                load_with_rename_map, merge_over_template,
                                read_weights, torch_rename_map)
from ..utils.debug import enable_nan_debugging
from ..utils.device import resolve_device
from ..utils.events import (CSVWriter, EventStorage, JSONWriter,
                            MetricPrinter, TensorboardWriter)
from ..utils.weights import seeded_init_
from .solver import build_optimizer, restore_opt_state

logger = logging.getLogger(__name__)

LSM_ARCHS = {"DistillProposalMMSSRCNN", "DistillOnlyProposalMMSSRCNN",
             "MMSSGridModel", "DistillMMSSGridModel"}


def proposal_slots(cfg) -> int:
    """Static proposal-slot count for the RPN-less PrecomputedProposals
    path (reference ovr_rcnn.py:59-61); 0 keeps DetectionBatch.proposals
    empty on the RPN path."""
    if cfg.MODEL.PROPOSAL_GENERATOR.NAME != "PrecomputedProposals":
        return 0
    if not cfg.MODEL.LOAD_OBJ_PROPOSALS:
        raise ValueError(
            "MODEL.PROPOSAL_GENERATOR.NAME='PrecomputedProposals' "
            "requires MODEL.LOAD_OBJ_PROPOSALS=True so the data "
            "pipeline can attach the OLN proposals as model inputs.")
    return cfg.TPU.MAX_PRECOMPUTED_PROPOSALS


def build_tokenizer(cfg) -> Optional[WordPieceTokenizer]:
    path = cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_PATH
    if path and os.path.exists(path):
        return WordPieceTokenizer.from_vocab_file(path)
    default = os.path.join(cfg.DATASETS.ROOT,
                           "datasets_data/bert/vocab.txt")
    if os.path.exists(default):
        return WordPieceTokenizer.from_vocab_file(default)
    logger.warning("No BERT vocab file found; using a tiny synthetic "
                   "vocab (set MODEL.LANGUAGE_BACKBONE.VOCAB_PATH).")
    return WordPieceTokenizer(build_tiny_vocab(["a", "photo", "of"]))


def build_test_loader(cfg, dataset_name: str,
                      tokenizer: Optional[WordPieceTokenizer],
                      needs_text: bool, val: bool = False) -> DataLoader:
    """Test loader (TEST.IMS_PER_BATCH) or validation-loss loader
    (SOLVER.IMS_PER_BATCH // world, the reference's
    build_detection_val_loader, dataloader.py:66-121), over the
    process's shard of the registered dataset."""
    get_register_dataset(dataset_name)(dataset_name, cfg.DATASETS.ROOT)
    records = DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    mapper = DetectionMapper(cfg, meta, is_train=False,
                             tokenizer=tokenizer, mlm=False, seed=0)
    rank, world = process_rank_world()
    sampler = InferenceSampler(len(records), rank=rank, world_size=world)
    if val:
        bs = max(cfg.SOLVER.IMS_PER_BATCH // world, 1)
    else:
        bs = max(cfg.TEST.IMS_PER_BATCH, 1)
    return DataLoader(records, mapper, sampler, bs,
                      derive_buckets(cfg, False), cfg.TPU.MAX_GT_BOXES,
                      has_text=needs_text, is_train=False,
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      worker_backend=cfg.DATALOADER.WORKER_BACKEND,
                      seed=0, rank=rank,
                      proposal_slots=proposal_slots(cfg))


def load_embeddings(cfg, dataset_name: str, device=None) -> torch.Tensor:
    """The class-embedding matrix registered for a dataset, [K + 1, D]
    with a zero background row, on ``device`` (the card unless the
    caller asks for the CPU). Falls back to seeded random embeddings
    when the embedding JSON is not on disk (smoke/test runs)."""
    get_register_dataset(dataset_name)(dataset_name, cfg.DATASETS.ROOT)
    meta = MetadataCatalog.get(dataset_name)
    mtx = meta.get("class_emb_mtx")
    if mtx is None:
        k = len(meta.get("thing_classes", [])) + 1
        logger.warning("No class embeddings for %s; using random",
                       dataset_name)
        mtx = np.random.RandomState(0).randn(
            k, cfg.MODEL.ROI_BOX_HEAD.EMB_DIM).astype(np.float32)
        mtx[-1] = 0.0
    return torch.from_numpy(np.asarray(mtx)).to(resolve_device(device))


def maybe_calibrate_int8(cfg, model: torch.nn.Module, dataset_name: str,
                         class_emb: torch.Tensor,
                         tokenizer: Optional[WordPieceTokenizer] = None,
                         needs_text: bool = False) -> bool:
    """The static int8 scheme's calibration before a dataset's first
    inference pass (JAX's ``OVRTrainer._maybe_calibrate_int8``): with
    ``TPU.INT8_EVAL`` and ``TPU.INT8_SCHEME`` static, unless every
    max-abs buffer of the model is already positive (calibrated in this
    process or restored from a checkpoint; one that a checkpoint lacked
    keeps its zero init, so it recalibrates), ``make_calibrate_step``
    over ``TPU.INT8_CALIB_BATCHES`` batches of the dataset's test loader
    (on several ranks, as many as the rank with the fewest has).
    A model without the buffers (one built otherwise, or an image-caption
    model, which JAX's ``hasattr(model, "calibrate_int8")`` skips) is
    left alone. Returns whether it calibrated."""
    if not (cfg.TPU.INT8_EVAL and cfg.TPU.INT8_SCHEME == "static"):
        return False
    amax = getattr(model, "amax_buffers", dict)()
    if not amax or bool(torch.stack(list(amax.values())).min() > 0):
        return False
    n = max(1, cfg.TPU.INT8_CALIB_BATCHES)
    batches = []
    loader = build_test_loader(cfg, dataset_name, tokenizer, needs_text)
    try:
        for batch in loader:
            if len(batches) >= n:
                break
            batches.append(batch)
    finally:
        loader.close()
    # every rank runs the same number of passes: each max-abs is
    # all-reduced where it is recorded, and a rank's shard may hold
    # fewer batches than another's
    n = len(batches)
    if process_rank_world()[1] > 1:
        count = torch.tensor([n], device=class_emb.device)
        torch.distributed.all_reduce(count,
                                     op=torch.distributed.ReduceOp.MIN)
        n = int(count)
    logger.info("Calibrating int8 activation scales on %d batches of "
                "%s...", n, dataset_name)
    step = make_calibrate_step(model)
    for batch in batches[:n]:
        step(batch, class_emb)
    return True


def test(cfg, model: torch.nn.Module, device=None,
         generator: Optional[torch.Generator] = None) -> Dict[str, Dict]:
    """Evaluation of ``model`` on each of ``cfg.DATASETS.TEST``
    (``OVRTrainer.test``): its test loader, its class embeddings on
    ``device`` (the card unless the caller asks for the CPU: where the
    model is); for an 'ovr' (the grid models) or ``loss_and_*``
    evaluation with ``TEST.DO_EVAL``, the loss-only pass
    (``inference_on_caption_dataset``, its draws from ``generator``, by
    default one seeded from ``cfg.SEED``); then, but for 'ovr', the eval
    step, the COCO or LVIS summary and the seen/unseen AP50, over the
    test loader or, with ``TEST.AUG.ENABLED``, over one loader per
    test-time augmentation merged by ``evaluation/tta.py``. Under the
    static int8 scheme the model is calibrated first
    (``maybe_calibrate_int8``). Returns {dataset: results}."""
    needs_text = cfg.MODEL.META_ARCHITECTURE in LSM_ARCHS
    tokenizer = build_tokenizer(cfg) if needs_text else None
    eval_step = make_eval_step(model)
    loss_step = make_loss_eval_step(model) if needs_text else None
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        etype = select_evaluator_type(cfg, dataset_name)
        loader = build_test_loader(cfg, dataset_name, tokenizer,
                                   needs_text)
        try:
            class_emb = load_embeddings(cfg, dataset_name, device)
            maybe_calibrate_int8(cfg, model, dataset_name, class_emb,
                                 tokenizer, needs_text)
            res = {}
            if etype in ("ovr", "loss_and_coco", "loss_and_lvis") and \
                    cfg.TEST.DO_EVAL and loss_step is not None:
                if generator is None:
                    generator = torch.Generator(
                        device=class_emb.device).manual_seed(
                            max(cfg.SEED, 0))
                metrics, losses = inference_on_caption_dataset(
                    loss_step, None, loader, class_emb, generator)
                res.update(metrics)
                res.update(losses)
            if etype != "ovr" and cfg.TEST.AUG.ENABLED:
                res.update(_test_with_tta(cfg, eval_step, class_emb,
                                          dataset_name, etype, tokenizer,
                                          needs_text))
            elif etype != "ovr":
                res.update(inference_on_detection_dataset(
                    eval_step, None, loader, class_emb, dataset_name,
                    etype=etype))
        finally:
            loader.close()
        results[dataset_name] = res
        logger.info("Results for %s: %s", dataset_name,
                    {k: round(v, 3) for k, v in res.items()
                     if isinstance(v, float) and "-" not in k})
    return results


def _test_with_tta(cfg, eval_step, class_emb, dataset_name: str,
                   etype: str, tokenizer, needs_text: bool) -> Dict:
    """The detection evaluation with test-time augmentation (JAX's
    ``OVRTrainer.test``, trainer.py:526-533): one loader per size and
    flip, closed after."""
    from ..evaluation.tta import build_tta_loaders, inference_with_tta
    loaders = build_tta_loaders(cfg, dataset_name, tokenizer, needs_text)
    try:
        return inference_with_tta(
            eval_step, None, loaders, class_emb, dataset_name,
            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            cfg.TEST.DETECTIONS_PER_IMAGE, etype=etype)
    finally:
        for loader, _ in loaders:
            loader.close()


def build_train_loader(cfg, tokenizer: Optional[WordPieceTokenizer],
                       needs_text: bool) -> DataLoader:
    """The training loader of ``cfg.DATASETS.TRAIN[0]``: the mapper with
    augmentation (and the MLM draws of an image-caption model), an
    infinite shuffled sampler over the process's shard, the training
    buckets, ``SOLVER.IMS_PER_BATCH`` split over the processes."""
    name = cfg.DATASETS.TRAIN[0]
    get_register_dataset(name)(name, cfg.DATASETS.ROOT)
    records = DatasetCatalog.get(name)
    meta = MetadataCatalog.get(name)
    seed = max(cfg.SEED, 0)
    mapper = DetectionMapper(
        cfg, meta, is_train=True, tokenizer=tokenizer,
        mlm=cfg.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING,
        seed=seed)
    rank, world = process_rank_world()
    sampler = TrainingSampler(len(records), seed=seed, rank=rank,
                              world_size=world)
    buckets = (tuple(cfg.TPU.IMAGE_BUCKETS) if cfg.TPU.IMAGE_BUCKETS
               else derive_buckets(cfg, True))
    gt_slots = (cfg.TPU.MAX_PRECOMPUTED_PROPOSALS
                if cfg.MODEL.LOAD_OBJ_PROPOSALS else cfg.TPU.MAX_GT_BOXES)
    return DataLoader(records, mapper, sampler,
                      cfg.SOLVER.IMS_PER_BATCH // world, buckets, gt_slots,
                      has_text=needs_text, is_train=True,
                      num_workers=cfg.DATALOADER.NUM_WORKERS,
                      worker_backend=cfg.DATALOADER.WORKER_BACKEND,
                      seed=seed, rank=rank,
                      proposal_slots=proposal_slots(cfg))


class OVRTrainer:
    """Builds the model, optimizer, loaders and writers of ``cfg`` on
    ``device`` (the card unless the caller asks for the CPU) and trains
    and evaluates it.

    The model is built eagerly with seeded weights from ``cfg.SEED``
    (``utils/weights.py:seeded_init_``), the same on every rank; JAX's
    initialisation from the first batch
    (``locov_tpu/engine/trainer.py:107-116``) has no counterpart.
    ``MODEL.WEIGHTS`` then loads over them (``load_pretrained``).
    Random draws: one device ``torch.Generator`` for the training steps
    and one for the loss-only evaluation, both seeded from ``cfg.SEED``
    and the rank (``rank_seed``: JAX's ``fold_in`` of the device index).
    Where ``TPU.PREFETCH_BATCHES`` > 0 a ``DevicePrefetcher`` moves the
    batches to the device ahead of the step. ``TPU.DEBUG_NANS`` turns on
    autograd's anomaly mode (``utils/debug.py``)."""

    def __init__(self, cfg, device=None):
        self.rank, self.world = process_rank_world()
        cfg = auto_scale_workers(cfg, self.world)
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.TPU.DEBUG_NANS:
            enable_nan_debugging()
        self.is_lsm = cfg.MODEL.META_ARCHITECTURE in LSM_ARCHS
        self.needs_text = self.is_lsm
        seed = max(cfg.SEED, 0)

        self.model = seeded_init_(build_meta_arch(cfg, device=self.device),
                                  seed)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Model has %.1fM parameters", n_params / 1e6)
        # loads below write into the same parameters
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.tokenizer = build_tokenizer(cfg) if self.needs_text else None
        self.train_loader = build_train_loader(cfg, self.tokenizer,
                                               self.needs_text)
        self._prefetcher = None
        self._train_iter = iter(self.train_loader)
        if cfg.TPU.PREFETCH_BATCHES > 0:
            # host decode/collate + host->device copy overlap with the
            # device step
            self._prefetcher = self._train_iter = DevicePrefetcher(
                self._train_iter, self.device,
                depth=cfg.TPU.PREFETCH_BATCHES)
        # class embeddings for the TRAIN vocabulary (trainer.py:365-407)
        self.class_emb = load_embeddings(cfg, cfg.DATASETS.TRAIN[0],
                                         self.device)

        self.checkpointer = Checkpointer(
            cfg.OUTPUT_DIR, max_to_keep=2,
            use_async=cfg.TPU.ASYNC_CHECKPOINT)
        self.last_import_report = None
        if cfg.MODEL.WEIGHTS:
            self.load_pretrained(cfg.MODEL.WEIGHTS)
        if cfg.MODEL.PROJECTION_WEIGHTS:
            self.load_projection_only(cfg.MODEL.PROJECTION_WEIGHTS)

        self.train_step = make_train_step(
            self.model, self.optimizer, self.scheduler,
            contrastive_scope=cfg.TPU.CONTRASTIVE_SCOPE)
        seed = rank_seed(seed, self.rank)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.eval_generator = torch.Generator(
            device=self.device).manual_seed(seed)

        self.start_iter = 0
        self.max_iter = cfg.SOLVER.MAX_ITER
        self.storage = EventStorage(0)
        self.writers = [
            MetricPrinter(self.max_iter, logger=logger.info),
            JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json")),
            CSVWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.csv"),
                      epoch_size=cfg.SOLVER.EPOCH_ITER_SIZE),
            TensorboardWriter(cfg.OUTPUT_DIR),
        ] if self.rank == 0 else []
        self._best_metric = None
        self._pending_metrics = None

    # ---------------------------------------------------------- checkpoints
    def state(self, iteration: int) -> dict:
        """What a checkpoint holds: the model's, the optimizer's (with
        the accumulation state of ``MultiSteps``) and the scheduler's
        ``state_dict``s and the iteration."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "iteration": iteration}

    def _save(self, save):
        """``save()`` (a checkpointer save) on rank 0, then a barrier of
        every rank, so that no rank runs ahead of the saved state."""
        if self.rank == 0:
            save()
        if self.world > 1:
            torch.distributed.barrier()

    def load_pretrained(self, weights: str):
        """Load MODEL.WEIGHTS: a d2-named torch .pth, a Caffe2 .pkl or a
        checkpoint of the port (any other name), by
        ``load_weights_standalone``: a checkpoint of a DIFFERENT
        meta-arch (the LSM -> STT stage hand-off) goes through the
        rename fan-out map, as the reference's
        resume_or_load_renaming_keys does (trainer.py:293-363). Writes
        ``import_report.json`` to OUTPUT_DIR."""
        if not os.path.exists(weights):
            logger.warning("MODEL.WEIGHTS %s not found; training from "
                           "scratch", weights)
            return
        self.last_import_report = load_weights_standalone(
            self.model, weights,
            report_dir=self.cfg.OUTPUT_DIR if self.rank == 0 else None)

    def load_projection_only(self, weights: str):
        """Load ONLY the V->L projection (v2l_projection / emb_pred)
        from a checkpoint (reference WSOGCheckpointer projection-only
        load, checkpoint.py:119-183)."""
        if not os.path.exists(weights):
            logger.warning("PROJECTION_WEIGHTS %s not found", weights)
            return
        proj = {k: v for k, v in read_weights(weights).items()
                if "v2l_projection" in k or "emb_pred" in k}
        merged, _ = load_with_rename_map(
            proj, self.model.state_dict(),
            torch_rename_map(STT_FROM_LSM_RENAME))
        logger.info("Loaded projection-only weights (%d source keys) "
                    "from %s", len(proj), weights)
        self.model.load_state_dict(merged)

    def resume_or_load(self, resume: bool):
        """Resume from last_checkpoint (model, optimizer, scheduler,
        iteration). MODEL.WEIGHTS is loaded once, by ``load_pretrained``
        in ``__init__`` (its same-arch check picks the rename map); JAX's
        branch here reads a .pth/.pkl MODEL.WEIGHTS a second time with
        the rename map and has no counterpart."""
        if resume and self.checkpointer.has_checkpoint():
            name = self.checkpointer.last_checkpoint()
            state = self.checkpointer.load(name)
            # merged over the model's own state: keys the model gained
            # after the checkpoint was written keep their init
            res = self.model.load_state_dict(merge_over_template(
                self.model.state_dict(), state["model"]), strict=False)
            if res.unexpected_keys:
                logger.warning("Checkpoint keys the model does not have: "
                               "%s", res.unexpected_keys)
            if "optimizer" in state:
                restore_opt_state(self.optimizer, self.scheduler, state)
            self.start_iter = self.checkpointer.resume_iteration(name)
            self.storage.iter = self.start_iter
            logger.info("Resumed from %s at iter %d", name,
                        self.start_iter)

    # ---------------------------------------------------------------- train
    def run_step(self):
        """One training step with an ASYNC metrics pipeline: the step
        for iteration t is launched, then the metrics of iteration t-1
        (copied to pinned host memory behind that step's kernels) are
        read. The host never waits on the step it just launched; the
        NaN tripwire (FloatingPointError, trainer.py:554-559) fires one
        step late, as in JAX."""
        start = time.perf_counter()
        batch = next(self._train_iter)
        data_time = time.perf_counter() - start
        if self._prefetcher is None:
            batch = to_torch(batch, self.device)
        lr = self.base_lr()
        metrics = self.train_step(batch, self.class_emb, self.generator)

        pending = self._pending_metrics
        self._pending_metrics = (_to_host_async(metrics),
                                 self.storage.iter)
        if pending is not None:
            self._record_metrics(*pending)

        self.storage.put_scalar("data_time", data_time)
        self.storage.put_scalar("time", time.perf_counter() - start)
        self.storage.put_scalar("lr", lr)

    def base_lr(self) -> float:
        """The learning rate the optimizer applies next, at SOLVER.BASE_LR's
        scale: a group's lr over its initial lr (the schedule's factor,
        restored on resume) times BASE_LR."""
        g = next(g for g in self.optimizer.param_groups if g["initial_lr"])
        return g["lr"] / g["initial_lr"] * self.cfg.SOLVER.BASE_LR

    def _record_metrics(self, pending, iteration: int):
        keys, host, event = pending
        if event is not None:
            event.synchronize()
        metrics = dict(zip(keys, host.tolist()))
        total = metrics.get("total_loss", 0.0)
        if not np.isfinite(total):
            bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
            raise FloatingPointError(
                f"Loss became infinite or NaN at iteration="
                f"{iteration}! Bad metrics: {bad}")
        for k, v in metrics.items():
            self.storage.put_scalar(k, v)

    def flush_metrics(self):
        if self._pending_metrics is not None:
            self._record_metrics(*self._pending_metrics)
            self._pending_metrics = None
        # device-memory telemetry (the reference prints GPUtil stats for
        # iters 100-300, trainer.py:111-112; we log it continuously)
        if self.device.type == "cuda":
            self.storage.put_scalar(
                "device_mem_gb",
                torch.cuda.memory_allocated(self.device) / 2 ** 30)

    def train(self):
        cfg = self.cfg
        logger.info("Starting training from iteration %d", self.start_iter)
        prof = None
        try:
            if cfg.TEST.EVAL_INIT and self.start_iter == 0:
                self.test_and_maybe_save()
            prof_dir = cfg.TPU.PROFILE_DIR
            for it in range(self.start_iter, self.max_iter):
                self.storage.iter = it
                if prof_dir and it == cfg.TPU.PROFILE_START:
                    prof = _start_profiler(self.device)
                self.run_step()
                if prof is not None and it == cfg.TPU.PROFILE_STOP:
                    self.flush_metrics()
                    _stop_profiler(prof, prof_dir)
                    prof = None
                self.after_step(it)
            self.flush_metrics()
            # final checkpoint + eval
            self._save(lambda: self.checkpointer.save_named(
                "model_final", self.state(self.max_iter - 1)))
            results = self.test_and_maybe_save(final=True)
            # commit the in-flight async save (it overlapped the eval)
            self.checkpointer.wait()
            return results
        finally:
            if prof is not None:
                _stop_profiler(prof, cfg.TPU.PROFILE_DIR)
            self.close()

    def close(self):
        """Deterministic teardown: the prefetch thread first (it reads
        the loader), then the loader's workers."""
        if self._prefetcher is not None:
            self._prefetcher.close()
        self.train_loader.close()

    def after_step(self, it: int):
        cfg = self.cfg
        if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            self._save(lambda: self.checkpointer.save_periodic(
                it, self.state(it)))
        if cfg.TEST.EVAL_PERIOD > 0 and (it + 1) % cfg.TEST.EVAL_PERIOD \
                == 0 and it + 1 != self.max_iter:
            self.test_and_maybe_save()
        if (it + 1) % cfg.SOLVER.LOG_PERIOD == 0:
            for w in self.writers:
                w.write(self.storage)

    # ----------------------------------------------------------------- test
    def test_and_maybe_save(self, final: bool = False) -> Dict:
        results = self.test(self.cfg)
        # best-metric tracking (trainer.py:246-265, checkpoint.py:186-234)
        metric_key = self.cfg.TEST.SAVE_MODEL_BEST_METRIC
        flat = {}
        for ds, res in results.items():
            for k, v in res.items():
                flat[f"{ds}/bbox/{k}"] = v
                if isinstance(v, (int, float)):
                    self.storage.put_scalar(f"{ds}/{k}", v)
        value = flat.get(metric_key)
        if value is not None and (self._best_metric is None
                                  or value > self._best_metric):
            self._best_metric = value
            self._save(lambda: self.checkpointer.save_best(
                self.storage.iter, self.state(self.storage.iter),
                metric_key, value))
        return results

    def test(self, cfg) -> Dict[str, Dict]:
        """``test`` of the module on the trainer's model and device, the
        loss-only pass drawing from the trainer's evaluation
        generator."""
        return test(cfg, self.model, self.device, self.eval_generator)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's generators: ``seed`` on rank 0 (one process
    draws as it always did), a seed derived from (seed, rank) on the
    others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _to_host_async(metrics: Dict[str, torch.Tensor]):
    """(keys, host tensor, event): the metrics stacked and copied to
    pinned host memory behind the work already queued, and the event to
    wait for before reading them (None on the CPU, where the copy is
    done on return)."""
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float().reshape(()) for k in keys])
    if stacked.device.type != "cuda":
        return keys, stacked, None
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return keys, host, event


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, prof_dir: str):
    prof.stop()
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
