"""Language backbones: full BERT and the embeddings-only BERT.

Counterpart of ``locov_tpu/models/language.py``. Tokenization and the
masked-language-modelling draws happen on the host (a ``TextBatch``);
these modules embed or encode on the device and give the
``CaptionFeatures`` the MMSS heads read: ``encoded_tokens`` (the encoder
output, or the word embeddings, with positions where asked, for the
embeddings-only type) and ``input_embeddings`` (the raw word
embeddings). ``LANGUAGE_BACKBONE.FREEZE`` is applied by the optimizer
(``engine/solver.py:default_frozen_fn``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..structures.batches import CaptionFeatures, TextBatch
from .bert import BertConfig, BertModel

LANGUAGE_BACKBONES = {}


def register_language_backbone(name):
    def deco(cls):
        LANGUAGE_BACKBONES[name] = cls
        return cls
    return deco


def _caption(text: TextBatch, encoded, input_embeddings) -> CaptionFeatures:
    return CaptionFeatures(
        input_ids=text.input_ids, attention_mask=text.attention_mask,
        special_tokens_mask=text.special_tokens_mask,
        target_ids=text.target_ids, mlm_mask=text.mlm_mask,
        encoded_tokens=encoded, input_embeddings=input_embeddings)


@register_language_backbone("build_bert_backbone")
class BertBackbone(nn.Module):
    """Full BERT: encoded_tokens = the encoder's output."""

    def __init__(self, bert_cfg: BertConfig):
        super().__init__()
        self.bert_model = BertModel(bert_cfg)

    def forward(self, text: TextBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> CaptionFeatures:
        encoded = self.bert_model(text.input_ids, text.attention_mask,
                                  deterministic=deterministic,
                                  generator=generator)
        word_emb = self.word_embedding_matrix()
        return _caption(text, encoded, word_emb[text.input_ids.long()])

    def word_embedding_matrix(self) -> torch.Tensor:
        return self.bert_model.embeddings.word_embeddings


@register_language_backbone("build_bertemb_backbone")
class BertEmbeddingBackbone(nn.Module):
    """Embeddings only (the LSM type, configs/coco_lsm.yaml):
    encoded_tokens = the word embeddings, plus positions and the
    LayerNorm with ``ADD_POSITION_EMBEDDING``. No encoder is built, and
    no LayerNorm without positions: Flax creates neither."""

    def __init__(self, bert_cfg: BertConfig,
                 add_position_embedding: bool = False):
        super().__init__()
        self.add_position_embedding = add_position_embedding
        self.bert_model = BertModel(bert_cfg, encoder=False,
                                    embeddings_norm=add_position_embedding)

    def forward(self, text: TextBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> CaptionFeatures:
        input_embeddings = self.word_embedding_matrix()[
            text.input_ids.long()]
        if self.add_position_embedding:
            encoded = self.bert_model.embed_only(
                text.input_ids, deterministic=deterministic,
                add_position=True, generator=generator)
        else:
            encoded = input_embeddings
        return _caption(text, encoded, input_embeddings)

    def word_embedding_matrix(self) -> torch.Tensor:
        return self.bert_model.embeddings.word_embeddings


def build_language_backbone(cfg) -> nn.Module:
    """``MODEL.LANGUAGE_BACKBONE.TYPE`` from the transformer head's
    BERT_CONFIG with the full-size BERT's depth (the 6-layer override of
    coco_lsm.yaml is the joint encoder's, not the language model's)."""
    name = cfg.MODEL.LANGUAGE_BACKBONE.TYPE
    if name not in LANGUAGE_BACKBONES:
        raise KeyError(f"Unknown LANGUAGE_BACKBONE.TYPE: {name}")
    bert_cfg = BertConfig.from_cfg_node(
        cfg.MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG)._replace(
            num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072)
    kwargs = {}
    if name == "build_bertemb_backbone":
        kwargs["add_position_embedding"] = \
            cfg.MODEL.LANGUAGE_BACKBONE.ADD_POSITION_EMBEDDING
    return LANGUAGE_BACKBONES[name](bert_cfg=bert_cfg, **kwargs)
