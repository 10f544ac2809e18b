"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is
driven on the CPU at a tiny size, once for each fault a cell can have
(one chip: no exchange between chips to leave out)."""
import torch

from benchmark.control import half_step
from benchmark.tests.tiny import cpu_run


def unchanged_step(step):
    """A step that returns its state unchanged: the parameters are put
    back after it."""
    def s(batch, class_emb, generator, uniforms=None):
        params = [p for p in _model_params(step)]
        saved = [p.detach().clone() for p in params]
        out = step(batch, class_emb, generator, uniforms)
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
        return out
    return s


def _model_params(step):
    """The trainable parameters that ``make_train_step``'s step closes
    over."""
    for c in step.__closure__ or ():
        v = c.cell_contents
        if isinstance(v, list) and v and isinstance(v[0], torch.nn.Parameter):
            return v
    raise AssertionError("no parameters in the step's closure")


def altered_step(step):
    """An answer altered where it is produced: every score shifted."""
    def s(batch, class_emb):
        d = step(batch, class_emb)
        return d._replace(scores=torch.where(d.mask, d.scores * 0.5,
                                             d.scores))
    return s


def half_infer_step(step):
    """Half of the batch left out: the second half's detections
    dropped."""
    def s(batch, class_emb):
        d = step(batch, class_emb)
        keep = torch.arange(d.mask.shape[0]) < d.mask.shape[0] // 2
        return d._replace(mask=d.mask & keep[:, None].to(d.mask.device),
                          scores=torch.where(keep[:, None].to(d.mask.device),
                                             d.scores, torch.zeros_like(
                                                 d.scores)))
    return s


def test_training_state_left_unchanged():
    res = cpu_run("lsm_global_b32", wrap_step=unchanged_step)
    assert res["correct"] is False
    assert res["checked"]["update_gap"]["value"] == 1.0


def test_training_half_the_batch_left_out():
    res = cpu_run("lsm_global_b32", wrap_step=half_step)
    assert res["correct"] is False
    assert res["checked"]["loss_gap"]["value"] > \
        res["checked"]["loss_gap"]["limit"]


def test_inference_answer_altered():
    res = cpu_run("stt_infer_b8", wrap_step=altered_step)
    assert res["correct"] is False
    assert res["checked"]["det_mse_ratio"]["value"] > \
        res["checked"]["det_mse_ratio"]["limit"]


def test_inference_half_the_batch_left_out():
    res = cpu_run("stt_infer_b8", wrap_step=half_infer_step)
    assert res["correct"] is False
    assert res["checked"]["det_mse_ratio"]["value"] > \
        res["checked"]["det_mse_ratio"]["limit"]
