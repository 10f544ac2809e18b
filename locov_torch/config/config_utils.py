"""Experiment-specific output-dir naming and epoch→iteration arithmetic.

Behavioral port of ``edit_output_dir_exp_specific``
(the reference's ovr/config/config_utils.py:5-151). Note the reference
reads ``SOLVER.STEPS_EPOCHS`` / ``TEST.EVAL_EPOCH`` which it never
defines (latent-broken epoch path); we define them with neutral defaults
so the epoch path actually works.
"""
import os


def edit_output_dir_exp_specific(cfg):
    base_dir = cfg.OUTPUT_DIR
    if os.path.isdir(base_dir):
        print("continue from existing folder")
        return cfg

    visual_text = "V-" + cfg.MODEL.BACKBONE.NAME.replace("build_", "").replace(
        "_backbone", "")
    if "resnet" in visual_text:
        # NB: reference has the same no-op here (str.replace result unused,
        # config_utils.py:16) — kept for byte-identical directory names.
        visual_text.replace("resnet", "resnet" + str(cfg.MODEL.RESNETS.DEPTH))
    visual_text += "_frz" + str(cfg.MODEL.BACKBONE.FREEZE_AT)

    lang_text = ""

    if "MMSS" in cfg.MODEL.META_ARCHITECTURE:
        visual_text += "_infeat-" + cfg.MODEL.MMSS_HEAD.IN_FEATURES
        if cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS:
            visual_text += (
                "_distill"
                + str(cfg.MODEL.MMSS_HEAD.DISTILLATION_TEMPERATURE)
                + "w"
                + str(cfg.MODEL.MMSS_HEAD.DISTILLATION_LOSS_WEIGHT)
                + ("_detachteacher"
                   if cfg.MODEL.MMSS_HEAD.DISTILLATION_DETACH_TEACHER else "")
                + ("_teachergrounding"
                   if not cfg.MODEL.MMSS_HEAD.DISTILLATION_TEACHER_TRANSFORMER
                   else "")
            )
        if (cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED
                and cfg.MODEL.ROI_BOX_HEAD.NORMALIZE_EMB_PRED):
            visual_text += "_normembd"
        if (cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED
                and cfg.MODEL.ROI_BOX_HEAD.STANDARDIZE_EMB_PRED):
            visual_text += "_standembd"

        lang_text = "L-" + cfg.MODEL.LANGUAGE_BACKBONE.TYPE.replace(
            "build_", "").replace("_backbone", "")
        lang_text += "_frz" if cfg.MODEL.LANGUAGE_BACKBONE.FREEZE else ""
    else:
        if cfg.MODEL.ROI_BOX_HEAD.NAME != "":
            visual_text += (
                "_" + cfg.MODEL.ROI_BOX_HEAD.NAME
                + ("-emb" if cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED else ""))
            visual_text += ("-cls_agnostic"
                            if cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG
                            else "")
        if (cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED
                and cfg.MODEL.ROI_BOX_HEAD.NORMALIZE_EMB_PRED):
            visual_text += "_normembd"
        if (cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED
                and cfg.MODEL.ROI_BOX_HEAD.STANDARDIZE_EMB_PRED):
            visual_text += "_standembd"

    opt_text = "S-" + "bs" + str(cfg.SOLVER.IMS_PER_BATCH)
    opt_text += "_lr" + str(cfg.SOLVER.BASE_LR)
    opt_text += "_sch-" + cfg.SOLVER.LR_SCHEDULER_NAME.lower()

    base_dir += "-" + cfg.MODEL.META_ARCHITECTURE
    base_dir += "-" + visual_text if len(visual_text) > 0 else ""
    base_dir += "-" + lang_text if len(lang_text) > 0 else ""
    base_dir += "-" + opt_text
    cfg.OUTPUT_DIR = base_dir

    # epoch → iteration conversion (config_utils.py:133-147)
    if cfg.SOLVER.MAX_EPOCHS != 0 and cfg.DATASETS.NUM_TRAINIG_SAMPLES != 0:
        epoch_iterations = (
            cfg.DATASETS.NUM_TRAINIG_SAMPLES // cfg.SOLVER.IMS_PER_BATCH)
        cfg.SOLVER.EPOCH_ITER_SIZE = epoch_iterations
        cfg.SOLVER.MAX_ITER = int(epoch_iterations * cfg.SOLVER.MAX_EPOCHS)
        if cfg.SOLVER.CHECKPOINT_PERIOD > 0:
            cfg.SOLVER.CHECKPOINT_PERIOD = (
                int(epoch_iterations) * cfg.SOLVER.CHECKPOINT_EPOCH)
        if cfg.SOLVER.STEPS_EPOCHS[0] != 0:
            cfg.SOLVER.STEPS = tuple(
                int(epoch_iterations * s) for s in cfg.SOLVER.STEPS_EPOCHS)
        if cfg.TEST.EVAL_EPOCH != 0:
            cfg.TEST.EVAL_PERIOD = int(epoch_iterations * cfg.TEST.EVAL_EPOCH)

    if cfg.SOLVER.CHECKPOINT_PERIOD == 0:
        cfg.SOLVER.CHECKPOINT_PERIOD = cfg.SOLVER.MAX_ITER + 10
    return cfg


def auto_scale_workers(cfg, num_workers: int):
    """d2 DefaultTrainer.auto_scale_workers (the reference invokes it at
    trainer.py:45): when SOLVER.REFERENCE_WORLD_SIZE > 0 and differs
    from the actual world size, linearly scale IMS_PER_BATCH / BASE_LR /
    MAX_ITER / WARMUP_ITERS / STEPS / EVAL_PERIOD / CHECKPOINT_PERIOD so
    the training trajectory is invariant to the number of workers."""
    old_world = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old_world == 0 or old_world == num_workers:
        return cfg
    frozen = cfg.is_frozen()
    if frozen:
        cfg.defrost()
    assert cfg.SOLVER.IMS_PER_BATCH % old_world == 0
    scale = num_workers / old_world
    bs = cfg.SOLVER.IMS_PER_BATCH = int(
        round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale))
                             for s in cfg.SOLVER.STEPS)
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(
        round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    print(f"Auto-scaling the config to batch_size={bs}, "
          f"learning_rate={cfg.SOLVER.BASE_LR}, "
          f"max_iter={cfg.SOLVER.MAX_ITER}, "
          f"warmup={cfg.SOLVER.WARMUP_ITERS}.")
    if frozen:
        cfg.freeze()
    return cfg
