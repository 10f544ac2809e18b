"""Default configuration tree.

Mirrors the config surface the reference actually consumes: the used
subset of detectron2's defaults plus every key appended by
``add_ovr_config`` (the reference's ovr/config/config.py:4-174), so the
shipped ``coco_lsm.yaml`` / ``coco_stt.yaml`` files merge unchanged.
TPU-specific knobs (static-shape buckets, mesh, dtypes) live under the
new ``TPU`` namespace — the core design divergence from the reference is
that every ragged structure becomes a fixed-size padded array.
"""
from .node import CfgNode as CN


def get_default_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.VIS_PERIOD = 0
    _C.CUDNN_BENCHMARK = False

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CN()
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    # Caffe2-trained R-50 convention: BGR input, mean-only normalization
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    # Freeze stem + res2 by default (matches d2); 0 disables freezing.
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.CONV_DIMS = [-1]

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
    # ovr addition (config.py:136)
    _C.MODEL.ROI_HEADS.DETACH_CLASS_PREDICTOR = False

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
    # ovr additions (config.py:123-133)
    _C.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = False
    _C.MODEL.ROI_BOX_HEAD.EMB_DIM = 768
    _C.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED = False
    _C.MODEL.ROI_BOX_HEAD.NORMALIZE_EMB_PRED = False
    _C.MODEL.ROI_BOX_HEAD.STANDARDIZE_EMB_PRED = False

    # ovr top-level additions (config.py:7-14)
    _C.MODEL.PROJECTION_WEIGHTS = ""
    _C.MODEL.BACKBONE_PREFIX = ("backbone.body.",)
    _C.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD = False
    _C.MODEL.LOAD_OBJ_PROPOSALS = False

    # ----------------------------------------------------- LANGUAGE_BACKBONE
    _C.MODEL.LANGUAGE_BACKBONE = CN()
    _C.MODEL.LANGUAGE_BACKBONE.TYPE = "build_bert_backbone"
    _C.MODEL.LANGUAGE_BACKBONE.FREEZE = True
    _C.MODEL.LANGUAGE_BACKBONE.EMBEDDING_PATH = ""
    _C.MODEL.LANGUAGE_BACKBONE.ADD_POSITION_EMBEDDING = False
    _C.MODEL.LANGUAGE_BACKBONE.PRETRAINED = True
    # TPU addition: where BERT vocab/weights live on disk (no network access)
    _C.MODEL.LANGUAGE_BACKBONE.VOCAB_PATH = ""
    _C.MODEL.LANGUAGE_BACKBONE.WEIGHTS_PATH = ""
    # TPU addition: architecture of the language BERT (bert-base-uncased
    # by default; shrinkable for tests/smoke runs)
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG = CN()
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.vocab_size = 30522
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.hidden_size = 768
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.num_hidden_layers = 12
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.num_attention_heads = 12
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.intermediate_size = 3072
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.max_position_embeddings = 512
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.hidden_dropout_prob = 0.1
    _C.MODEL.LANGUAGE_BACKBONE.BERT_CONFIG.attention_probs_dropout_prob = 0.1

    # --------------------------------------------------------------- MMSS_HEAD
    _C.MODEL.MMSS_HEAD = CN()
    _C.MODEL.MMSS_HEAD.TYPES = ("GroundingHead",)
    _C.MODEL.MMSS_HEAD.DEFAULT_HEAD = "GroundingHead"
    _C.MODEL.MMSS_HEAD.TIE_VL_PROJECTION_WEIGHTS = False
    _C.MODEL.MMSS_HEAD.IN_FEATURES = "res5"
    _C.MODEL.MMSS_HEAD.SPATIAL_DROPOUT = -1
    _C.MODEL.MMSS_HEAD.DISTILLATION_LOSS = False
    _C.MODEL.MMSS_HEAD.DISTILLATION_LOSS_TYPE = "KD"
    _C.MODEL.MMSS_HEAD.DISTILLATION_TEMPERATURE = 1.0
    _C.MODEL.MMSS_HEAD.DISTILLATION_LOSS_WEIGHT = 1.0
    _C.MODEL.MMSS_HEAD.DISTILLATION_DETACH_TEACHER = False
    _C.MODEL.MMSS_HEAD.DISTILLATION_TEACHER_TRANSFORMER = True

    _C.MODEL.MMSS_HEAD.GROUNDING = CN()
    _C.MODEL.MMSS_HEAD.GROUNDING.LOCAL_METRIC = "dot"
    _C.MODEL.MMSS_HEAD.GROUNDING.GLOBAL_METRIC = "aligned_local"
    _C.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT = "softmax"
    _C.MODEL.MMSS_HEAD.GROUNDING.ALIGNMENT_TEMPERATURE = 10.0
    _C.MODEL.MMSS_HEAD.GROUNDING.LOSS = "cross_entropy"
    _C.MODEL.MMSS_HEAD.GROUNDING.NEGATIVE_MINING = "random"
    _C.MODEL.MMSS_HEAD.GROUNDING.TRIPLET_MARGIN = 1.0
    _C.MODEL.MMSS_HEAD.GROUNDING.ALIGN_WORDS_TO_REGIONS = True
    _C.MODEL.MMSS_HEAD.GROUNDING.ALIGN_REGIONS_TO_WORDS = True
    _C.MODEL.MMSS_HEAD.GROUNDING.CONV_EMB = (1, 2, 3)
    _C.MODEL.MMSS_HEAD.GROUNDING.TEXT_INPUT = "input_embeddings"

    _C.MODEL.MMSS_HEAD.TRANSFORMER = CN()
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING = False
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB = 0.15
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB_MASK = 0.9
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_PROB_NOISE = 0.0
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_LANGUAGE_MODELING_VALIDATION = True
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MASKED_VISUAL_MODELING = False
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MVM_LOSS = ""
    # TPU-side extension (no reference key): True replaces the
    # reference's raw-additive attention mask (vilbert-lineage quirk —
    # the 0/1 mask is ADDED to pre-softmax logits, so attention leaks
    # to padded caption/region slots; transformer_head.py:170-176)
    # with standard (1-m)*-inf masking. Default False for behavioral
    # parity with reference-trained checkpoints.
    _C.MODEL.MMSS_HEAD.TRANSFORMER.PROPER_ATTENTION_MASK = False
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MVM_LOSS_NUM_NEGATIVE = 128
    _C.MODEL.MMSS_HEAD.TRANSFORMER.MMM_LOSS = ""
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG = CN()
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.vocab_size = 30522
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_size = 768
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_hidden_layers = 12
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_attention_heads = 12
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.intermediate_size = 3072
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_act = "gelu"
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.hidden_dropout_prob = 0.1
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.attention_probs_dropout_prob = 0.1
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.max_position_embeddings = 512
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.type_vocab_size = 2
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.initializer_range = 0.02
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.layer_norm_eps = 1e-12
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.pad_token_id = 0
    _C.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.gradient_checkpointing = False
    _C.MODEL.MMSS_HEAD.TRANSFORMER.pretrained_weights = False

    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG = CN()
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.TYPE = "RN50_text"
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.EMBED_DIM = 1024
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.CONTEXT_LENGHT = 77
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.VOCAB_SIZE = 49408
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.TRANSFORMER_WIDTH = 512
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.TRANSFORMER_HEADS = 8
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.TRANSFORMER_LAYERS = 12
    _C.MODEL.MMSS_HEAD.TRANSFORMER.CLIP_CONFIG.WEIGHTS_PRETRAINED = True

    _C.MODEL.MMSS_HEAD.TRANSFORMER.WORD_EMBEDDING_CONFIG = CN()
    _C.MODEL.MMSS_HEAD.TRANSFORMER.WORD_EMBEDDING_CONFIG.VOCAB_PATH = ""
    _C.MODEL.MMSS_HEAD.TRANSFORMER.WORD_EMBEDDING_CONFIG.EMBEDDING_WORD_VECS_PATH = ""

    _C.MODEL.MMSS_HEAD.MLP = CN()

    # ---------------------------------------------------------------- INPUT
    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    # ovr additions (config.py:151-174)
    _C.INPUT.NOISE_OFFLINE = False
    _C.INPUT.NOISE_BBOX = 0.0
    _C.INPUT.NOISE_CLS = 0.0
    _C.INPUT.NOISE_RM_BBOX = 0.0
    _C.INPUT.NOISE_LOC = 0.0
    _C.INPUT.NOISE_IGN = 0.0
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.COLOR_JITTER = 0.0
    _C.INPUT.RANDOM_GRAY_SCALE = False
    _C.INPUT.GAUSSIAN_BLUR = False
    _C.INPUT.RANDOM_ERASE = False

    # -------------------------------------------------------------- DATASETS
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ()
    _C.DATASETS.TEST = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    _C.DATASETS.DATASET_CLASS = ""
    _C.DATASETS.NUM_TRAINIG_SAMPLES = 0
    # TPU addition: root dir holding datasets_data/ (images, annotations,
    # proposals, embeddings) — reference hardcodes relative paths.
    _C.DATASETS.ROOT = "."

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
    # Parallel-map backend for the mapper workers: "threads" (default;
    # decode/resize release the GIL) or "processes" (fork pool — GIL
    # -free fallback for hosts where pure-Python mapper work binds).
    _C.DATALOADER.WORKER_BACKEND = "threads"

    # ---------------------------------------------------------------- SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    # epoch-denominated schedule (read but never defined by the reference,
    # config_utils.py:141-147 — defined here so the epoch path works)
    _C.SOLVER.STEPS_EPOCHS = (0,)
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = None
    # named (commented out) in the reference configs
    # (configs/coco_lsm.yaml:114-115) but never implemented there;
    # functional here via optax.MultiSteps (engine/solver.py)
    _C.SOLVER.GRADIENT_ACCUMULATION_STEPS = 1
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CN()
    _C.SOLVER.AMP.ENABLED = False
    # ovr additions (config.py:139-143)
    _C.SOLVER.LOG_PERIOD = 20
    _C.SOLVER.MAX_EPOCHS = 0
    _C.SOLVER.EPOCH_ITER_SIZE = 1000
    _C.SOLVER.CHECKPOINT_EPOCH = 1

    # ------------------------------------------------------------------ TEST
    _C.TEST = CN()
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CN()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100,
                             1200)
    _C.TEST.AUG.MAX_SIZE = 4000
    _C.TEST.AUG.FLIP = True
    _C.TEST.PRECISE_BN = CN()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200
    # ovr additions (config.py:146-149)
    _C.TEST.DO_EVAL = True
    _C.TEST.IMS_PER_BATCH = 16
    _C.TEST.EVAL_INIT = False
    _C.TEST.SAVE_MODEL_BEST_METRIC = "val/bbox/AP50"
    _C.TEST.EVAL_EPOCH = 0

    # ------------------------------------------------------------------- TPU
    # Static-shape / sharding knobs with no reference counterpart; these
    # replace detectron2's dynamic ImageList/Instances machinery.
    _C.TPU = CN()
    # images are resized (shortest edge per INPUT.*) then padded to the
    # smallest (H, W) bucket that fits; each bucket is one XLA program.
    _C.TPU.IMAGE_BUCKETS = ((640, 640), (640, 1024), (1024, 640), (1024, 1024))
    _C.TPU.SIZE_DIVISIBILITY = 32
    _C.TPU.MAX_GT_BOXES = 100
    # precomputed OLN proposals kept per image (objectness>thr capped here)
    _C.TPU.MAX_PRECOMPUTED_PROPOSALS = 200
    _C.TPU.TEXT_MAX_LEN = 70          # BertEmbedding path (transf_models.py:110)
    _C.TPU.TEXT_MAX_LEN_FULL = 100    # full-BERT path   (transf_models.py:31)
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.PARAM_DTYPE = "float32"
    _C.TPU.MESH_AXES = ("data",)
    _C.TPU.REMAT_BACKBONE = False
    _C.TPU.DEBUG_NANS = False         # LoggedModule-style NaN tripwires
    # chunk size for the transformer head's all-pairs encoder pass
    _C.TPU.PAIRWISE_CHUNK = 0          # 0 = no chunking
    # Fuse DistillProposalMMSSRCNN's grid-MMSS and box-MMSS passes into
    # one transformer-head invocation (2*B*B pairs in one encoder/LM
    # call instead of two B*B calls): per-group math is identical (the
    # groups never attend to each other; equivalence-tested) and the
    # per-pass op count halves. The default keeps the reference's
    # two-pass structure.
    _C.TPU.FUSED_MMSS_PASSES = False
    # the JAX package's training ROIAlign as a Pallas kernel (same
    # interpolation weights as the matmul formulation)
    _C.TPU.USE_PALLAS_ROIALIGN = False
    # opt-in int8 serving mode: trunk (res2-res4) + res5 convs run
    # int8 x int8 -> int32 on the MXU at inference (dynamic per-tensor
    # activation scales, per-channel BN-folded weight scales — the JAX
    # package's ops/int8_conv.py). Training is untouched. Not ported yet.
    _C.TPU.INT8_EVAL = False
    # activation-scale scheme for INT8_EVAL: "dynamic" computes
    # per-tensor maxima on the fly (data-free); "static" uses maxima
    # calibrated by OvrRCNN.calibrate_int8 (mutable "quant"
    # collection), letting the quantize fuse into producer epilogues
    _C.TPU.INT8_SCHEME = "dynamic"
    # batches of the test loader used to calibrate the static scheme's
    # activation maxima (OVRTrainer calibrates automatically before the
    # first eval pass; the quant collection then persists in params and
    # checkpoints)
    _C.TPU.INT8_CALIB_BATCHES = 4
    # with INT8_SCHEME="static": run ROIAlign itself int8 x int8 (the
    # [B,chunk,Q,H,C] chunk intermediate is written to HBM as int8,
    # halving this HBM-bound op's dominant traffic; interpolation
    # weights quantize per-row — ops/roi_align.py
    # roi_align_batched_int8). Off = bf16 interpolation with the fused
    # int8 output epilogue (roi_align_batched_quant).
    _C.TPU.INT8_ROIALIGN = True
    # depth of the host->device input pipeline (DevicePrefetcher);
    # 0 disables prefetch (batches transfer synchronously in run_step)
    _C.TPU.PREFETCH_BATCHES = 2
    # async orbax checkpointing: disk IO overlaps training; bookkeeping
    # (last_checkpoint pointer, pruning) is deferred to the commit
    # barrier (utils/checkpoint.py:Checkpointer)
    _C.TPU.ASYNC_CHECKPOINT = True
    # BxB contrastive scope: "local" = per-device batch (reference DDP
    # parity); "global" = all-gathered global batch (stronger signal,
    # costlier transformer-head pass)
    _C.TPU.CONTRASTIVE_SCOPE = "local"
    # profiler trace capture: set a directory to capture a trace of
    # iterations [PROFILE_START, PROFILE_STOP) (the reference only has
    # an IterationTimer + GPUtil prints, SURVEY.md §5)
    _C.TPU.PROFILE_DIR = ""
    _C.TPU.PROFILE_START = 100
    _C.TPU.PROFILE_STOP = 105
    # persistent XLA compilation cache for the production CLI: "auto"
    # derives a host-keyed dir (utils/misc.compile_cache_dir), "" turns
    # the cache off, anything else is used as the directory verbatim.
    # Amortizes large first compiles across restarts and jobs.
    _C.TPU.COMPILE_CACHE_DIR = "auto"

    return _C


def add_ovr_config(cfg: CN) -> None:
    """Parity shim: the reference calls ``add_ovr_config(cfg)`` on top of
    d2 defaults (train_ovnet.py:44). Our defaults already include every
    ovr key, so this is a no-op kept for CLI-surface compatibility."""
    return None
