"""Batching: samplers, size-bucket grouping, static padded collation.

The port's own copy of ``locov_tpu/data/loader.py``, on the port's
batch containers (``structures/batches.py``): batches hold numpy
arrays, and ``structures.batches.to_torch`` moves them to the device.
Replaces d2's ``build_detection_train_loader`` / samplers / trivial
collate plus the reference's custom test/val loaders
(``ovr/data/dataloader.py:11-121``). Where d2 groups by aspect ratio
(2 groups) and pads each batch to its own max size, we group into a
small set of STATIC (H, W) buckets, as the JAX package does, so every
batch has one of a few shapes.
"""
from __future__ import annotations

import queue as queue_mod
from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..structures.batches import (DetectionBatch, GtBatch, ImageBatch,
                                  TextBatch)


def round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def derive_buckets(cfg, is_train: bool) -> List[tuple]:
    """Static (H, W) buckets from the INPUT resize config: square,
    landscape and portrait variants aligned to SIZE_DIVISIBILITY."""
    div = cfg.TPU.SIZE_DIVISIBILITY
    if is_train:
        short = max(cfg.INPUT.MIN_SIZE_TRAIN)
        long = cfg.INPUT.MAX_SIZE_TRAIN
    else:
        short = cfg.INPUT.MIN_SIZE_TEST
        long = cfg.INPUT.MAX_SIZE_TEST
    short = round_up(min(short, long), div)
    long = round_up(long, div)
    if short == long:
        return [(short, short)]
    return [(short, short), (short, long), (long, short)]


class TrainingSampler:
    """Infinite shuffled index stream, sharded per host
    (d2 TrainingSampler semantics)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            idx = (g.permutation(self.size) if self.shuffle
                   else np.arange(self.size))
            yield from idx[self.rank::self.world_size].tolist()


class InferenceSampler:
    """Contiguous per-host split of [0, size) (d2 InferenceSampler)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard = (size + world_size - 1) // world_size
        self.begin = min(rank * shard, size)
        self.end = min(self.begin + shard, size)

    def __iter__(self):
        return iter(range(self.begin, self.end))

    def __len__(self):
        return self.end - self.begin


def _pad_image(img: np.ndarray, bucket) -> np.ndarray:
    h, w = img.shape[:2]
    bh, bw = bucket
    out = np.zeros((bh, bw, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def _pick_bucket(hw, buckets):
    h, w = hw
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return max(buckets, key=lambda b: b[0] * b[1])


def _pad_rows(arr: np.ndarray, n: int, fill=0):
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    k = min(len(arr), n)
    if k:
        out[:k] = arr[:k]
    return out


def collate(records: List[dict], bucket, gt_slots: int,
            has_text: bool, proposal_slots: int = 0) -> DetectionBatch:
    """Stack fixed-size records into one static DetectionBatch.

    Images land in ONE preallocated float32 buffer: the uint8->f32
    cast, the pad-to-bucket and the batch stack fuse into a single
    copy per record (the naive astype+pad+stack chain costs 3x the
    memory traffic and dominated the host pipeline)."""
    bh, bw = bucket
    images = np.zeros((len(records), bh, bw, records[0]["image"].shape[2]),
                      np.float32)
    for i, r in enumerate(records):
        h, w = r["image"].shape[:2]
        images[i, :h, :w] = r["image"]  # assigns with cast in one pass
    hw = np.stack([r["hw"] for r in records])
    orig_hw = np.stack([r["orig_hw"] for r in records])
    image_id = np.stack([r["image_id"] for r in records])

    def gt_batch(prefix):
        boxes = np.stack([_pad_rows(r[f"{prefix}boxes"], gt_slots)
                          for r in records])
        classes = np.stack([_pad_rows(r[f"{prefix}classes"], gt_slots)
                            for r in records])
        mask = np.stack([
            np.arange(gt_slots) < len(r[f"{prefix}boxes"])
            for r in records])
        return GtBatch(boxes=boxes.astype(np.float32),
                       classes=classes.astype(np.int32), mask=mask)

    gt = gt_batch("gt_")
    gt_obj = gt_batch("gt_obj_") if "gt_obj_boxes" in records[0] else None

    # precomputed (OLN) proposals as MODEL INPUTS — filled only for the
    # RPN-less PrecomputedProposals path (reference ovr_rcnn.py:59-61)
    proposals = None
    if proposal_slots > 0 and "proposal_boxes" in records[0]:
        from ..structures.batches import ProposalBatch
        pboxes = np.stack([_pad_rows(r["proposal_boxes"], proposal_slots)
                           for r in records])
        pobj = np.stack([
            _pad_rows(r["proposal_objectness"], proposal_slots,
                      fill=-1e4) for r in records])
        pmask = np.stack([
            np.arange(proposal_slots) < len(r["proposal_boxes"])
            for r in records])
        proposals = ProposalBatch(boxes=pboxes.astype(np.float32),
                                  objectness=pobj.astype(np.float32),
                                  mask=pmask)

    text = None
    if has_text and "input_ids" in records[0]:
        text = TextBatch(
            input_ids=np.stack([r["input_ids"] for r in records]),
            attention_mask=np.stack([r["attention_mask"]
                                     for r in records]),
            special_tokens_mask=np.stack([r["special_tokens_mask"]
                                          for r in records]),
            target_ids=np.stack([r["target_ids"] for r in records]),
            mlm_mask=np.stack([r["mlm_mask"] for r in records]))

    return DetectionBatch(
        images=ImageBatch(image=images, hw=hw, orig_hw=orig_hw,
                          image_id=image_id),
        gt=gt, proposals=proposals, text=text, gt_obj=gt_obj)


class DataLoader:
    """Maps + bucket-groups + collates, with optional thread prefetch.

    For training: infinite iterator. For eval: finite; a final partial
    batch is filled by repeating the last record with image_id = -1 so
    the evaluator can drop padding images.

    ``worker_backend`` selects the parallel-map implementation:
    "threads" (default; decode/resize release the GIL, so threads
    scale: the JAX package's tools/bench_loader.py) or "processes" —
    a fork-based
    pool for hosts where pure-Python mapper work (tokenize, noise
    injectors, box transforms) binds on the GIL at high worker counts
    (the d2 reference always pays process-pool serialization;
    we make it the fallback, not the default).
    """

    def __init__(self, records: Sequence[dict], mapper, sampler,
                 batch_size: int, buckets: Sequence[tuple],
                 gt_slots: int, has_text: bool, is_train: bool,
                 num_workers: int = 0, worker_backend: str = "threads",
                 seed: int = None, rank: int = 0,
                 proposal_slots: int = 0):
        self.records = records
        self.mapper = mapper
        self.sampler = sampler
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.gt_slots = gt_slots
        self.has_text = has_text
        self.is_train = is_train
        self.num_workers = num_workers
        if worker_backend not in ("threads", "processes"):
            raise ValueError(
                f"DATALOADER.WORKER_BACKEND must be 'threads' or "
                f"'processes', got {worker_backend!r}")
        self.worker_backend = worker_backend
        self.proposal_slots = proposal_slots
        # per-worker seed base: configured seed (falling back to the
        # mapper's) mixed with the host rank so multi-host pods never
        # draw identical augmentation/MLM streams
        if seed is None:
            seed = getattr(mapper, "seed", 0) or 0
        self._seed_base = (int(seed) * 1000003 + int(rank) * 7919) \
            % (2 ** 31 - 1)
        self._pool = None
        # the fork pool is created EAGERLY, before the caller starts
        # threads of its own (a thread-backend loader, a prefetcher) —
        # forking a multi-threaded parent risks a child inheriting a
        # held lock; the workers never touch the GPU
        if num_workers > 0 and worker_backend == "processes":
            self._pool = _make_pool(mapper, records, num_workers,
                                    self._seed_base)

    def close(self):
        """Terminate the worker pool deterministically. Without this an
        abandoned training loader keeps num_workers live processes (and
        up to workers*4 in-flight ~3MB results) until GC collects the
        generator."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        try:
            n = len(self.sampler)
        except TypeError:
            raise TypeError("infinite loader has no length")
        return (n + self.batch_size - 1) // self.batch_size

    def _mapped(self):
        it = iter(self.sampler)
        if self.num_workers > 0 and self.worker_backend == "processes":
            if self._pool is None:  # re-opened after close()
                self._pool = _make_pool(self.mapper, self.records,
                                        self.num_workers, self._seed_base)
            yield from _pool_map(self._pool, it, self.num_workers,
                                 self._seed_base)
        elif self.num_workers > 0:
            yield from _thread_map(
                lambda i: self.mapper(self.records[i]), it,
                self.num_workers)
        else:
            for i in it:
                yield self.mapper(self.records[i])

    def __iter__(self) -> Iterator[DetectionBatch]:
        queues: Dict[tuple, list] = {b: [] for b in self.buckets}
        count = 0
        for rec in self._mapped():
            b = _pick_bucket(rec["hw"], self.buckets)
            queues[b].append(rec)
            count += 1
            if len(queues[b]) == self.batch_size:
                yield collate(queues[b], b, self.gt_slots, self.has_text,
                              self.proposal_slots)
                queues[b] = []
        # finite epoch: flush leftovers as padded batches
        for b, rs in queues.items():
            if not rs:
                continue
            while len(rs) < self.batch_size:
                filler = dict(rs[-1])
                filler["image_id"] = np.int64(-1)
                rs.append(filler)
            yield collate(rs, b, self.gt_slots, self.has_text,
                          self.proposal_slots)


# Worker-process state, installed by _proc_init via fork inheritance
# (initargs are NOT pickled under the fork start method, so the mapper
# may hold unpicklable members like a loaded tokenizer).
_PROC_STATE: dict = {}


def _proc_init(mapper, records, seed_base, counter):
    import random as _random

    _PROC_STATE["mapper"] = mapper
    _PROC_STATE["records"] = records
    # fork duplicates the parent's RNG state into EVERY worker; reseed
    # the process-global RNGs per worker (the mapper's own RNGs are
    # reseeded PER TASK in _proc_call — see there for why). The worker
    # index comes from a shared counter, not the pid, so seeds are
    # deterministic across runs/hosts.
    with counter.get_lock():
        widx = counter.value
        counter.value += 1
    wseed = (seed_base + (widx + 1) * 100003) % (2 ** 31 - 1)
    _random.seed(wseed)
    np.random.seed(wseed % (2 ** 31 - 1))


def _proc_call(i, tseed):
    """Map one record with PER-TASK mapper reseeding: the task seed is
    derived from (cfg seed, host rank, task ordinal) on the parent, so
    augmentation/MLM draws are reproducible for a fixed cfg.SEED no
    matter which worker picks up which task (per-WORKER streams would
    make output depend on the racy task->worker assignment), distinct
    across hosts, and distinct when the sampler revisits a record in a
    later epoch (the ordinal keeps advancing)."""
    mapper = _PROC_STATE["mapper"]
    r = getattr(mapper, "rng", None)
    if r is not None and hasattr(r, "seed"):
        r.seed(tseed)
    npr = getattr(mapper, "np_rng", None)
    if npr is not None:
        npr.seed(tseed % (2 ** 31 - 1))
    return mapper(_PROC_STATE["records"][i])


def _make_pool(mapper, records, workers, seed_base):
    """Fork-based worker pool with deterministic per-worker seeding.

    Uses the fork start method deliberately (mapper state — tokenizer,
    catalogs — is inherited, never pickled). Fork from a multi-threaded
    parent is hazardous (a child can inherit a held lock), which is why
    DataLoader creates this pool EAGERLY at construction time, before
    the caller's own threads exist."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    counter = ctx.Value("i", 0)
    return ctx.Pool(processes=workers, initializer=_proc_init,
                    initargs=(mapper, records, seed_base, counter))


def _pool_map(pool, it, workers, seed_base=0):
    """Ordered parallel map on a persistent process pool with the same
    bounded in-flight window as ``_thread_map``.

    GIL-free fallback (``DATALOADER.WORKER_BACKEND='processes'``) for
    hosts where the pure-Python mapper slice (tokenize, noise
    injectors) binds threads; costs one pickle of each mapped record
    (~3 MB uint8 image) per transfer. apply_async + an explicit window
    rather than ``Pool.imap`` because imap's feeder thread consumes the
    (infinite training) sampler without bound. The pool outlives this
    generator; DataLoader.close() tears it down. Each task carries its
    own seed (see _proc_call) so results don't depend on scheduling."""
    depth = max(workers * 4, 1)
    window: "queue_mod.Queue" = queue_mod.Queue()
    for task_no, i in enumerate(it):
        tseed = (seed_base + (task_no + 1) * 100003) % (2 ** 31 - 1)
        window.put(pool.apply_async(_proc_call, (i, tseed)))
        if window.qsize() >= depth:
            yield window.get().get()
    while not window.empty():
        yield window.get().get()


def _process_map(mapper, records, it, workers, seed_base=0):
    """One-shot convenience wrapper: ephemeral pool + _pool_map
    (kept for tests/tools; DataLoader uses its persistent pool)."""
    pool = _make_pool(mapper, records, workers, seed_base)
    try:
        yield from _pool_map(pool, it, workers, seed_base)
    finally:
        pool.terminate()
        pool.join()


def _thread_map(fn, it, workers):
    """Ordered parallel map over an iterator on a PERSISTENT worker
    pool with a bounded in-flight window (workers * 4).

    The JPEG decode + resize path releases the GIL inside libjpeg/PIL,
    so threads scale for the mapper workload; a persistent pool avoids
    the per-record thread spawn the first implementation paid
    (~100 us + scheduler churn per record — at 100+ records/s that was
    measurable pure overhead in the JAX package's
    tools/bench_loader.py)."""
    from concurrent.futures import ThreadPoolExecutor

    src = iter(it)
    depth = max(workers * 4, 1)
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="loader")
    window: "queue_mod.Queue" = queue_mod.Queue()
    try:
        for x in src:
            window.put(pool.submit(fn, x))
            if window.qsize() >= depth:
                yield window.get().result()
        while not window.empty():
            yield window.get().result()
    finally:
        while not window.empty():
            window.get().cancel()
        pool.shutdown(wait=False)
