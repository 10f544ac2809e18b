"""The trainer's device paths on the card: ``DevicePrefetcher``'s pinned
copies on a side stream hand over a batch's exact bytes, with the
consumer's stream ordered after the copy, and an async
``Checkpointer`` save of CUDA state holds the values of the call when
the caller changes the tensors in place right after it returns. Every
test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on
a machine with the card and no JAX, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_trainer_gpu.py
"""
import numpy as np
import pytest
import torch

from locov_torch.parallel.mesh import DevicePrefetcher
from locov_torch.structures import batches as tb
from locov_torch.structures.batches import to_torch
from locov_torch.utils.checkpoint import Checkpointer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetcher's stream and the "
                    "pinned copies have no CPU mode")
    return torch.device("cuda")


def _batches(n):
    """Full-width batches of numpy arrays, as the loader collates them."""
    rng = np.random.RandomState(0)
    return [tb.DetectionBatch(
        images=tb.ImageBatch(
            image=(rng.rand(2, 800, 1344, 3) * 255).astype(np.float32),
            hw=np.full((2, 2), 800, np.int32),
            orig_hw=np.full((2, 2), 640, np.int32),
            image_id=np.arange(2, dtype=np.int64) + i),
        gt=tb.GtBatch(boxes=rng.rand(2, 200, 4).astype(np.float32),
                      classes=rng.randint(0, 80, (2, 200)).astype(np.int32),
                      mask=rng.rand(2, 200) > 0.5)) for i in range(n)]


def test_prefetcher_hands_over_the_bytes(cuda):
    batches = _batches(4)
    pf = DevicePrefetcher(iter(batches), cuda, depth=2)
    for b in batches:
        got = next(pf)
        # read at once on the consumer's stream, as the step does
        total = got.images.image.sum()
        want = to_torch(b, cuda)
        assert got.images.image.device.type == "cuda"
        for x, y in zip(tuple(got.images) + tuple(got.gt),
                        tuple(want.images) + tuple(want.gt)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert float(total) == float(want.images.image.sum())
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_async_checkpoint_copies_cuda_state_before_returning(cuda,
                                                             tmp_path):
    w = torch.randn(2048, 2048, device=cuda)
    want = w.cpu()
    ck = Checkpointer(str(tmp_path), use_async=True)
    ck.save_periodic(1, {"model": {"w": w}, "iteration": 1})
    w.add_(1.0)  # the next step, in place, on the card
    ck.wait()
    got = ck.load("model_0000001")["model"]["w"]
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert ck.saves[0]["bytes"] > 2048 * 2048 * 4
