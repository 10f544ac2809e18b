"""Mutual-distillation losses between the grounding and transformer
heads' pairwise cost matrices.

Counterpart of ``locov_tpu/models/mmss/distill.py``: ``MultiDistillLoss``
(KD), ``MultiDistillLossJS`` and ``MultiDistillLossL2`` of the
reference, with the transformer-teacher / grounding-teacher switch and
the detach-teacher option. The JS variant compares the image-direction
students against the caption-direction means, as the reference does.
"""
from __future__ import annotations

import torch

from ...ops.losses import kl_div_batchmean


def _softmaxes(pw_cost, temp):
    x = -pw_cost / temp
    p_cap = torch.softmax(x, dim=0)
    p_img = torch.softmax(x, dim=1).t()
    l_cap = torch.log_softmax(x, dim=0)
    l_img = torch.log_softmax(x, dim=1).t()
    return p_cap, p_img, l_cap, l_img


def kd_loss(trans_pw, w2r_pw, r2w_pw, temp, loss_weight=1.0,
            detach_teacher=False, transformer_teacher=True):
    t2 = temp * temp
    if transformer_teacher:
        if detach_teacher:
            trans_pw = trans_pw.detach()
        p_cap, p_img, _, _ = _softmaxes(trans_pw, temp)
        _, _, lw_cap, lw_img = _softmaxes(w2r_pw, temp)
        _, _, lr_cap, lr_img = _softmaxes(r2w_pw, temp)
        loss = (kl_div_batchmean(lw_cap, p_cap)
                + kl_div_batchmean(lr_cap, p_cap)
                + kl_div_batchmean(lw_img, p_img)
                + kl_div_batchmean(lr_img, p_img)) * t2
    else:
        if detach_teacher:
            w2r_pw, r2w_pw = w2r_pw.detach(), r2w_pw.detach()
        _, _, l_cap, l_img = _softmaxes(trans_pw, temp)
        pw_cap, pw_img, _, _ = _softmaxes(w2r_pw, temp)
        pr_cap, pr_img, _, _ = _softmaxes(r2w_pw, temp)
        loss = (kl_div_batchmean(l_cap, pw_cap)
                + kl_div_batchmean(l_cap, pr_cap)
                + kl_div_batchmean(l_img, pw_img)
                + kl_div_batchmean(l_img, pr_img)) * t2
    return loss * loss_weight


def _detach_teacher(trans_pw, w2r_pw, r2w_pw, detach_teacher,
                    transformer_teacher):
    if transformer_teacher and detach_teacher:
        trans_pw = trans_pw.detach()
    elif detach_teacher:
        w2r_pw, r2w_pw = w2r_pw.detach(), r2w_pw.detach()
    return trans_pw, w2r_pw, r2w_pw


def js_loss(trans_pw, w2r_pw, r2w_pw, temp, loss_weight=1.0,
            detach_teacher=False, transformer_teacher=True):
    trans_pw, w2r_pw, r2w_pw = _detach_teacher(
        trans_pw, w2r_pw, r2w_pw, detach_teacher, transformer_teacher)
    t2 = temp * temp
    p_cap, _, l_cap, l_img = _softmaxes(trans_pw, temp)
    pw_cap, _, lw_cap, lw_img = _softmaxes(w2r_pw, temp)
    pr_cap, _, lr_cap, lr_img = _softmaxes(r2w_pw, temp)
    m_cap_w2r = 0.5 * (p_cap + pw_cap)
    m_cap_r2w = 0.5 * (p_cap + pr_cap)
    js = (0.5 * kl_div_batchmean(l_cap, m_cap_w2r) * t2
          + 0.5 * kl_div_batchmean(lw_cap, m_cap_w2r) * t2
          + 0.5 * kl_div_batchmean(l_cap, m_cap_r2w) * t2
          + 0.5 * kl_div_batchmean(lr_cap, m_cap_r2w) * t2
          # the image-direction terms against the caption means, as the
          # reference has them
          + 0.5 * kl_div_batchmean(l_img, m_cap_w2r) * t2
          + 0.5 * kl_div_batchmean(lw_img, m_cap_w2r) * t2
          + 0.5 * kl_div_batchmean(l_img, m_cap_r2w) * t2
          + 0.5 * kl_div_batchmean(lr_img, m_cap_r2w) * t2)
    return js * loss_weight


def mse_loss(trans_pw, w2r_pw, r2w_pw, temp, loss_weight=1.0,
             detach_teacher=False, transformer_teacher=True):
    trans_pw, w2r_pw, r2w_pw = _detach_teacher(
        trans_pw, w2r_pw, r2w_pw, detach_teacher, transformer_teacher)

    def mse(a, b):
        return ((a - b) ** 2).mean()
    loss = (mse(trans_pw, w2r_pw) + mse(trans_pw, r2w_pw)
            + mse(trans_pw.t(), w2r_pw.t()) + mse(trans_pw.t(), r2w_pw.t()))
    return loss * loss_weight


DISTILL_LOSSES: dict = {"KD": kd_loss, "JS": js_loss, "MSE": mse_loss}
