"""PyTorch port vs JAX: the host data layer (``locov_torch/data``).

The port keeps its own copy of the framework-free data layer. On one
micro-COCO tree (written by each package's ``synthetic.py``; the two
trees are byte for byte equal) the registered records and metadata, the
mapped records, the collated batches (both loader backends, a padded
final batch, the training loader with captions and masked-LM draws) and
the tokenizer's ids are equal in the two packages: same shapes, dtypes
and values, no tolerance (the same host code on the same bytes).
"""
import os
import sys

import numpy as np
import pytest

from locov_tpu.data import get_register_dataset as jregister
from locov_tpu.data import loader as jloader
from locov_tpu.data import mappers as jmappers
from locov_tpu.data import transforms as jtr
from locov_tpu.data.catalog import DatasetCatalog as JCat
from locov_tpu.data.catalog import MetadataCatalog as JMeta
from locov_tpu.data.synthetic import make_micro_coco as jmake
from locov_tpu.data.synthetic import micro_cfg as jmicro_cfg
from locov_tpu.data.tokenization import WordPieceTokenizer as JTok
from locov_torch.data import get_register_dataset as tregister
from locov_torch.data import loader as tloader
from locov_torch.data import mappers as tmappers
from locov_torch.data import transforms as ttr
from locov_torch.data.catalog import DatasetCatalog as TCat
from locov_torch.data.catalog import MetadataCatalog as TMeta
from locov_torch.data.synthetic import make_micro_coco as tmake
from locov_torch.data.synthetic import micro_cfg as tmicro_cfg
from locov_torch.data.tokenization import WordPieceTokenizer as TTok
from locov_torch.engine import trainer as ttrainer
from locov_torch.utils import native
from test_torch_eval_helpers import assert_same_tree, fresh_catalogs

META_KEYS = ("thing_classes", "thing_dataset_id_to_contiguous_id",
             "evaluator_type", "captions_dict", "class_emb_mtx",
             "object_proposals", "freq_classes")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("jax_micro"))
    troot = str(tmp_path_factory.mktemp("torch_micro"))
    jmake(jroot, n_val=5)
    tmake(troot, n_val=5)
    return jroot, troot


@pytest.fixture
def registered(trees):
    """register(name) -> (jax records, port records, jax meta, port
    meta), each package on its own tree."""
    fresh_catalogs()
    jroot, troot = trees

    def register(name):
        jregister(name)(name, jroot)
        tregister(name)(name, troot)
        return JCat.get(name), TCat.get(name), JMeta.get(name), \
            TMeta.get(name)
    yield register
    fresh_catalogs()


def _rebase(records, src, dst):
    """Records of the tree at ``src`` with file names under ``dst``."""
    return [{**r, "file_name": r["file_name"].replace(src, dst)}
            for r in records]


def test_micro_trees_are_byte_equal(trees):
    a, b = (_files(r) for r in trees)
    assert len(a) == 28 and set(a) == set(b)
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("name", [
    "coco_zeroshot_val", "coco_generalized_zeroshot_val",
    "coco_captions_train_seen_proposals", "lvis_v1_generalized_val",
    "lvis_v1_base_train", "lvis_v1_caption_train_proposals"])
def test_registered_records_match_jax(registered, trees, name):
    jrec, trec, jmeta, tmeta = registered(name)
    assert len(trec) > 0
    assert_same_tree(_rebase(jrec, *trees), trec, name)
    for key in META_KEYS:
        assert_same_tree(jmeta.get(key), tmeta.get(key), key)


def _mapper_case(case, jroot, troot):
    """(dataset, is_train, config edits, tokenizer?, mlm?)"""
    return {
        "eval": ("coco_zeroshot_val", False, {}, False, False),
        "eval_captions": ("coco_generalized_zeroshot_val", False, {},
                          True, False),
        "train_mlm_flip": ("coco_captions_train", True, {}, True, True),
        "train_proposals": ("coco_captions_train_seen_proposals", True,
                            {"MODEL.LOAD_OBJ_PROPOSALS": True}, True,
                            True),
        "train_noise": ("coco_zeroshot_train", True,
                        {"INPUT.NOISE_BBOX": 0.5, "INPUT.NOISE_CLS": 0.3,
                         "INPUT.NOISE_LOC": 0.3,
                         "INPUT.NOISE_RM_BBOX": 0.3}, False, False),
    }[case]


def _cfgs(jroot, troot, arch, edits):
    out = []
    for make, root in ((jmicro_cfg, jroot), (tmicro_cfg, troot)):
        cfg = make(root, arch)
        for key, value in edits.items():
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, value)
        out.append(cfg)
    return out


@pytest.mark.parametrize("case", ["eval", "eval_captions",
                                  "train_mlm_flip", "train_proposals",
                                  "train_noise"])
def test_mapped_records_match_jax(registered, trees, case):
    jroot, troot = trees
    name, is_train, edits, text, mlm = _mapper_case(case, jroot, troot)
    jrec, trec, jmeta, tmeta = registered(name)
    jcfg, tcfg = _cfgs(jroot, troot, "DistillProposalMMSSRCNN", edits)
    vocab = os.path.join("datasets_data", "bert", "vocab.txt")
    jtok = JTok.from_vocab_file(os.path.join(jroot, vocab)) if text else None
    ttok = TTok.from_vocab_file(os.path.join(troot, vocab)) if text else None
    jm = jmappers.DetectionMapper(jcfg, jmeta, is_train, tokenizer=jtok,
                                  mlm=mlm, seed=3)
    tm = tmappers.DetectionMapper(tcfg, tmeta, is_train, tokenizer=ttok,
                                  mlm=mlm, seed=3)
    for _ in range(2):  # a second pass draws other flips and masks
        for a, b in zip(jrec, trec):
            ja, tb = jm(a), tm(b)
            assert_same_tree(ja, tb, case)
    if case == "train_proposals":
        assert "gt_obj_boxes" in tb and (tb["gt_classes"] == 1).all()
    if text:
        assert "input_ids" in tb and tb["input_ids"].shape == (12,)


def test_black_image_fallback_matches_jax(registered, trees):
    jrec, trec, jmeta, tmeta = registered("coco_captions_val")
    jcfg, tcfg = _cfgs(*trees, "DistillProposalMMSSRCNN", {})
    a = {**jrec[0], "file_name": "/nonexistent/missing.jpg"}
    b = {**trec[0], "file_name": "/nonexistent/missing.jpg"}
    ja = jmappers.DetectionMapper(jcfg, jmeta, False)(a)
    tb = tmappers.DetectionMapper(tcfg, tmeta, False)(b)
    assert_same_tree(ja, tb)
    assert tb["image"].sum() == 0 and tb["caption"] == "A black image."


def _loaders(registered, trees, name, backend, workers, batch_size,
             is_train=False, text=False):
    jroot, troot = trees
    jrec, trec, jmeta, tmeta = registered(name)
    jcfg, tcfg = _cfgs(jroot, troot, "DistillProposalMMSSRCNN", {})
    vocab = os.path.join("datasets_data", "bert", "vocab.txt")
    out = []
    for pkg, mappers, cfg, rec, meta, tok, root in (
            (jloader, jmappers, jcfg, jrec, jmeta, JTok, jroot),
            (tloader, tmappers, tcfg, trec, tmeta, TTok, troot)):
        tk = tok.from_vocab_file(os.path.join(root, vocab)) if text \
            else None
        mapper = mappers.DetectionMapper(cfg, meta, is_train, tokenizer=tk,
                                         mlm=is_train, seed=5)
        sampler = (pkg.TrainingSampler(len(rec), seed=5) if is_train
                   else pkg.InferenceSampler(len(rec)))
        out.append(pkg.DataLoader(
            rec, mapper, sampler, batch_size, pkg.derive_buckets(cfg, False),
            cfg.TPU.MAX_GT_BOXES, has_text=text, is_train=is_train,
            num_workers=workers, worker_backend=backend, seed=5))
    return out


@pytest.mark.parametrize("backend,workers", [("threads", 0),
                                             ("threads", 2),
                                             ("processes", 2)])
def test_collated_batches_match_jax(registered, trees, backend, workers):
    """Eval batches with captions, tokenized: 5 images (3 landscape, 2
    portrait) in batches of 2, so the landscape bucket ends in a padded
    batch."""
    jl, tl = _loaders(registered, trees, "coco_generalized_zeroshot_val",
                      backend, workers, 2, text=True)
    with jl, tl:
        assert len(jl) == len(tl) == 3
        jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        assert_same_tree(a, b)
        assert type(b).__module__ == "locov_torch.structures.batches"
        assert isinstance(b.images.image, np.ndarray)
    ids = np.concatenate([b.images.image_id for b in tb])
    assert (ids == -1).sum() == 1  # the partial batch's pad row
    assert {b.images.image.shape[1:3] for b in tb} == {(64, 96), (96, 64)}


def test_training_batches_match_jax(registered, trees):
    """The infinite training loader: shuffled, flipped, captions drawn
    and masked, over more batches than the dataset holds (mapped in the
    loop: mapping threads share the mapper's random streams, so their
    draws follow the threads' race in both packages)."""
    jl, tl = _loaders(registered, trees, "coco_captions_train", "threads",
                      0, 4, is_train=True, text=True)
    with jl, tl:
        ji, ti = iter(jl), iter(tl)
        for _ in range(4):
            a, b = next(ji), next(ti)
            assert_same_tree(a, b)
        assert b.text is not None and b.text.mlm_mask.shape == (4, 12)


def test_build_test_loader_matches_jax(registered, trees):
    """``engine/trainer.py:build_test_loader`` against the loader JAX's
    ``OVRTrainer.build_test_loader`` builds (TEST.IMS_PER_BATCH 8, a
    multiple of the JAX CPU mesh's 8 devices, so no rounding)."""
    jroot, troot = trees
    name = "coco_zeroshot_val"
    jrec, trec, jmeta, tmeta = registered(name)
    jcfg, tcfg = _cfgs(jroot, troot, "OvrRCNN", {})
    jl = jloader.DataLoader(
        jrec, jmappers.DetectionMapper(jcfg, jmeta, False, seed=0),
        jloader.InferenceSampler(len(jrec)), 8,
        jloader.derive_buckets(jcfg, False), jcfg.TPU.MAX_GT_BOXES,
        has_text=False, is_train=False, seed=0)
    tl = ttrainer.build_test_loader(tcfg, name, None, False)
    jb, tb = list(jl), list(tl)
    tl.close()
    assert len(tb) == 2
    for a, b in zip(jb, tb):
        assert_same_tree(a, b)


@pytest.mark.parametrize("decoder", ["cv2", "pil"])
def test_decode_and_resize_match_jax(trees, monkeypatch, decoder):
    """``read_image`` and ``resize_shortest_edge`` through cv2 and, with
    cv2 hidden, through PIL, in both packages. The two resizers agree
    within 1 when they enlarge (their rounding), as the evaluation
    does (640 x 480 -> 1067 x 800); shrinking, PIL filters over the
    source's footprint and cv2 does not, so they differ there."""
    if decoder == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)
    jroot, troot = trees
    rel = os.path.join("datasets_data", "coco", "val2017",
                       "000000002001.jpg")
    for fmt in ("BGR", "RGB"):
        a = jmappers.read_image(os.path.join(jroot, rel), fmt)
        b = tmappers.read_image(os.path.join(troot, rel), fmt)
        assert_same_tree(a, b)
    assert b.shape == (72, 64, 3) and b.dtype == np.uint8
    for short, long_ in ((64, 96), (800, 1333), (40, 50)):
        ra, _ = jtr.resize_shortest_edge(a, short, long_)
        rb, _ = ttr.resize_shortest_edge(b, short, long_)
        assert_same_tree(ra, rb)
    assert rb.shape == (45, 40, 3)
    up, _ = ttr.resize_shortest_edge(b, 800, 1333)
    monkeypatch.undo()
    other, _ = ttr.resize_shortest_edge(b, 800, 1333)  # the other one
    assert other.shape == up.shape == (900, 800, 3)
    assert np.abs(other.astype(int) - up.astype(int)).max() <= 1


def test_tokenizer_matches_jax_on_both_paths(trees):
    """ASCII captions through the port's native tokenizer (built under
    ``build/native/``) and its Python tokenizer, against JAX's."""
    jroot, troot = trees
    vocab = os.path.join("datasets_data", "bert", "vocab.txt")
    jt = JTok.from_vocab_file(os.path.join(jroot, vocab))
    tt = TTok.from_vocab_file(os.path.join(troot, vocab))
    texts = ["a photo of a cat and a dog", "A Black image.",
             "cars, dogs!? 'quoted' x-y", "", "a " * 20, "café cat"]
    for s in texts:
        assert_same_tree(jt.encode(s, 12), tt.encode(s, 12), s)
    assert tt._native() is not None  # the native path ran
    assert os.path.exists(native.lib_path("wordpiece"))
    assert native.lib_path("wordpiece").startswith(native.BUILD_DIR)
    tt._native_handle, tt._native_failed = None, True  # the Python path
    for s in texts:
        assert_same_tree(jt.encode(s, 12), tt.encode(s, 12), s)
    assert_same_tree(jt.encode_batch(texts, 12), tt.encode_batch(texts, 12))


def test_buckets_and_samplers_match_jax():
    from locov_tpu.config import get_cfg as jget
    from locov_torch.config import get_cfg as tget
    jc, tc = jget(), tget()
    for is_train in (False, True):
        assert jloader.derive_buckets(jc, is_train) == \
            tloader.derive_buckets(tc, is_train)
    assert tloader.derive_buckets(tc, False) == [(800, 800), (800, 1344),
                                                 (1344, 800)]
    for hw in ((800, 1067), (1067, 800), (800, 800), (2000, 10)):
        assert jloader._pick_bucket(hw, jloader.derive_buckets(jc, False)) \
            == tloader._pick_bucket(hw, tloader.derive_buckets(tc, False))
    for rank in range(3):
        assert list(jloader.InferenceSampler(10, rank, 3)) == \
            list(tloader.InferenceSampler(10, rank, 3))
        ja = iter(jloader.TrainingSampler(7, seed=1, rank=rank,
                                          world_size=3))
        ta = iter(tloader.TrainingSampler(7, seed=1, rank=rank,
                                          world_size=3))
        assert [next(ja) for _ in range(9)] == [next(ta) for _ in range(9)]


def test_load_embeddings_registered_and_fallback(registered, trees):
    """The registered class-embedding matrix, and JAX's seeded random
    fallback (``np.random.RandomState(0)``) where the dataset has no
    embedding file."""
    _, troot = trees
    _, _, jmeta, _ = registered("coco_zeroshot_val")
    cfg = tmicro_cfg(troot)
    got = ttrainer.load_embeddings(cfg, "coco_zeroshot_val", "cpu")
    np.testing.assert_array_equal(got.numpy(), jmeta.class_emb_mtx)
    assert got.shape == (4, 16) and (got[-1] == 0).all()
    fb = ttrainer.load_embeddings(cfg, "lvis_instance_v1_val", "cpu")
    want = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    want[-1] = 0.0
    np.testing.assert_array_equal(fb.numpy(), want)
