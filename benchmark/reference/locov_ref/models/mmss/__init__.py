"""The MMSS heads of the image-caption stage (counterpart of
``locov_tpu/models/mmss``)."""
from .distill import DISTILL_LOSSES, js_loss, kd_loss, mse_loss
from .grounding_head import GroundingConfig, GroundingHead
from .mlp_head import MLPHead
from .transformer_head import (TransformerHead, TransformerHeadConfig,
                               VisualEmbedding)

__all__ = [
    "GroundingHead", "GroundingConfig", "MLPHead", "TransformerHead",
    "TransformerHeadConfig", "VisualEmbedding", "DISTILL_LOSSES",
    "kd_loss", "js_loss", "mse_loss",
]
