"""The port's data slice against the JAX package's on the CPU, bit for bit:
the synthetic generators, `make_dataset` for each dataset branch, the
ModelNet40, S3DIS and ScanNet loaders on tiny files in the standard
layouts (the ModelNet40 subsample through `native/batcher.cpp` built by
the port), `pad_scene`, the `Prefetcher`, and the eval batches' padding
mask. Mirrors `tests/test_loaders.py` and `tests/test_utils.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from gridgcn_tpu.configs.base import DataConfig as JDataConfig
from gridgcn_tpu.data import native as jnative
from gridgcn_tpu.data import pipeline as jpipeline
from gridgcn_tpu.data import s3dis as js3dis
from gridgcn_tpu.data import scannet as jscannet
from gridgcn_tpu.data import synthetic as jsynthetic
from gridgcn_tpu.data.modelnet40 import load_modelnet40 as jload_modelnet40
from gridgcn_torch.configs.base import DataConfig
from gridgcn_torch.data import native, pipeline, s3dis, scannet, synthetic
from gridgcn_torch.data.modelnet40 import load_modelnet40
from tests.test_loaders import _write_modelnet

torch.set_num_threads(1)


def assert_same(a, b):
    """Equal arrays (or tuples of them), dtype and all."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,args", [
    ("synthetic_classification", (24, 128, 6, 3)),
    ("synthetic_segmentation", (5, 300, 4, 2)),
    ("synthetic_shapes40", (50, 200, 1)),
    ("synthetic_scene_surface", (2000, 5, (6.0, 2.6, 5.0), True)),
    ("synthetic_feature_field", (1500, 4, 5)),
])
def test_synthetic_generators_are_bit_for_bit(name, args):
    assert_same(getattr(synthetic, name)(*args),
                getattr(jsynthetic, name)(*args))


def check_make_dataset(root, task="seg", num_classes=4, **kw):
    for split in ("train", "test"):
        t = pipeline.make_dataset(DataConfig(root=str(root), **kw), split,
                                  num_classes, task)
        j = jpipeline.make_dataset(JDataConfig(root=str(root), **kw), split,
                                   num_classes, task)
        assert (t.task, t.num_classes, t.size) == (j.task, j.num_classes,
                                                   j.size)
        assert_same(t.points, j.points)
        assert_same(t.labels, j.labels)
        assert (t.features is None) == (j.features is None)
        if t.features is not None:
            assert_same(t.features, j.features)


@pytest.mark.parametrize("kw", [
    dict(dataset="synthetic", num_points=64),
    dict(dataset="synthetic", num_points=64, num_feats=3),
    dict(dataset="synthetic", num_points=64, _cls=True),
    dict(dataset="synthetic_shapes40", num_points=64, synthetic_size=40,
         _cls=True),
    dict(dataset="synthetic_scene", num_points=512, synthetic_size=3),
    dict(dataset="synthetic_scene", num_points=512, synthetic_size=3,
         num_feats=6),
    dict(dataset="synthetic_field", num_points=512, synthetic_size=3,
         num_feats=6),
    dict(dataset="synthetic_field", num_points=512, synthetic_size=3),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_make_dataset_synthetic_branches(tmp_path, kw):
    kw = dict(kw)
    task = "cls" if kw.pop("_cls", False) else "seg"
    check_make_dataset(tmp_path, task=task,
                       num_classes=40 if task == "cls" else 4, **kw)


def test_native_runtime_is_the_repos(tmp_path):
    """The port's build of native/batcher.cpp draws the JAX package's
    subsets (its checked-in library); np.take (the port's row gather) and
    the histograms are the same bytes."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(7, 300, 3)).astype(np.float32)
    idx = np.array([3, 0, 6, 6, 2], np.int32)
    for n_out, seed in ((100, 0), (300, 5), (512, 9)):
        assert_same(native.sample_points(src, idx, n_out, seed=seed),
                    jnative.sample_points(src, idx, n_out, seed=seed))
    assert jnative.available()
    assert_same(np.take(src, idx, axis=0), jnative.gather_rows(src, idx))
    labels = rng.integers(-1, 6, (4, 50)).astype(np.int32)
    assert_same(native.label_histogram(labels, 5),
                jnative.label_histogram(labels, 5))
    with pytest.raises(IndexError):
        native.sample_points(src, np.array([7], np.int32), 10)


def test_modelnet40_loader_and_dataset(tmp_path):
    _write_modelnet(tmp_path)
    for split in ("train", "test"):
        assert_same(load_modelnet40(str(tmp_path), split, 1024),
                    jload_modelnet40(str(tmp_path), split, 1024))
    check_make_dataset(tmp_path, task="cls", num_classes=40,
                       dataset="modelnet40", num_points=1024)
    t = pipeline.make_dataset(DataConfig(dataset="modelnet40",
                                         root=str(tmp_path)), "train", 40,
                              "cls")
    assert t.size == 6


def _write_s3dis_npy(root, n=5, points=256):
    base = root / "s3dis"
    base.mkdir()
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        np.save(base / f"s3dis_{split}_points.npy",
                rng.uniform(0, 1, (n, points, 9)).astype(np.float32))
        np.save(base / f"s3dis_{split}_labels.npy",
                rng.integers(0, 13, (n, points)).astype(np.int32))
    np.save(base / "s3dis_test_rooms.npy",
            np.array(["b", "a", "b", "c", "a"], object), allow_pickle=True)
    return base


def test_s3dis_npy_loader_and_holdout(tmp_path):
    base = _write_s3dis_npy(tmp_path)
    for split in ("train", "test"):
        assert_same(s3dis.load_s3dis(str(tmp_path), split, 128),
                    js3dis.load_s3dis(str(tmp_path), split, 128))
    t = s3dis.load_s3dis_rooms(str(tmp_path), "test", 128)
    j = js3dis.load_s3dis_rooms(str(tmp_path), "test", 128)
    assert_same(t[:4], j[:4])
    assert t[4] == j[4] == ["a", "b", "c"]
    check_make_dataset(tmp_path, dataset="s3dis", num_points=200,
                       num_classes=13)
    with pytest.raises(ValueError, match="Area_3"):
        s3dis.load_s3dis(str(tmp_path), "train", 64, holdout="Area_3")
    (base / "s3dis_holdout.txt").write_text("Area_3\n")
    assert_same(s3dis.load_s3dis(str(tmp_path), "train", 64,
                                 holdout="Area_3"),
                js3dis.load_s3dis(str(tmp_path), "train", 64,
                                  holdout="Area_3"))
    with pytest.raises(ValueError, match="Area_3"):
        s3dis.load_s3dis(str(tmp_path), "train", 64)


def test_s3dis_hdf5_area5_split(tmp_path):
    h5py = pytest.importorskip("h5py")
    h5dir = tmp_path / "s3dis" / "indoor3d_sem_seg_hdf5_data"
    h5dir.mkdir(parents=True)
    rng = np.random.default_rng(2)
    with h5py.File(h5dir / "ply_data_all_0.h5", "w") as h5:
        h5["data"] = rng.uniform(0, 1, (6, 512, 9)).astype(np.float32)
        h5["label"] = rng.integers(0, 13, (6, 512)).astype(np.uint8)
    (h5dir / "all_files.txt").write_text(
        "indoor3d_sem_seg_hdf5_data/ply_data_all_0.h5\n")
    rooms = ["Area_1_office_1"] * 3 + ["Area_5_office_1"] * 2 + [
        "Area_3_hall_2"]
    (h5dir / "room_filelist.txt").write_text("\n".join(rooms) + "\n")
    for split, n in (("train", 4), ("test", 2)):
        t = s3dis.load_s3dis(str(tmp_path), split, 400)
        assert t[0].shape[0] == n
        assert_same(t, js3dis.load_s3dis(str(tmp_path), split, 400))
        t = s3dis.load_s3dis(str(tmp_path), split, 400, holdout="Area_3")
        assert_same(t, js3dis.load_s3dis(str(tmp_path), split, 400,
                                         holdout="Area_3"))
    t = s3dis.load_s3dis_rooms(str(tmp_path), "test", 400)
    j = js3dis.load_s3dis_rooms(str(tmp_path), "test", 400)
    assert_same(t[:4], j[:4])
    assert t[4] == j[4]


def test_scannet_loader_dense_and_ragged(tmp_path):
    base = tmp_path / "scannet"
    base.mkdir()
    rng = np.random.default_rng(3)
    np.save(base / "scannet_train_points.npy",
            rng.uniform(0, 5, (4, 900, 3)).astype(np.float32))
    np.save(base / "scannet_train_labels.npy",
            rng.integers(0, 21, (4, 900)).astype(np.int32))
    scenes = np.empty(3, object)
    labs = np.empty(3, object)
    for i, n in enumerate((900, 70, 512)):
        scenes[i] = rng.uniform(0, 5, (n, 3)).astype(np.float32)
        labs[i] = rng.integers(0, 21, n).astype(np.int32)
    np.save(base / "scannet_test_points.npy", scenes, allow_pickle=True)
    np.save(base / "scannet_test_labels.npy", labs, allow_pickle=True)
    for split in ("train", "test"):
        t = scannet.load_scannet(str(tmp_path), split, 512)
        assert t[0].shape[1:] == (512, 3)
        assert_same(t, jscannet.load_scannet(str(tmp_path), split, 512))
    check_make_dataset(tmp_path, dataset="scannet", num_points=512,
                       num_classes=21)


def test_pad_scene():
    pts = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32)
    labs = np.arange(100, dtype=np.int32)
    p, l, m = scannet.pad_scene(pts, labs, 128)
    assert_same((p, l, m), jscannet.pad_scene(pts, labs, 128))
    assert m.sum() == 100 and not m[100:].any()
    with pytest.raises(ValueError, match="static capacity"):
        scannet.pad_scene(pts, labs, 50)


def test_prefetcher_order_and_errors():
    out = list(pipeline.Prefetcher(iter(range(7)), lambda x: x * 2, depth=3))
    assert out == [0, 2, 4, 6, 8, 10, 12]

    def bad_gen():
        yield 1
        raise RuntimeError("boom")

    pf = pipeline.Prefetcher(bad_gen(), lambda x: x)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        for _ in pf:
            pass


def test_eval_batches_mark_padded_examples_and_feed_the_steps():
    """drop_last=False pads the final partial batch with clouds drawn again;
    example_mask marks the real ones, as in the JAX package; to_device
    gives the steps' dtypes."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (10, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 10).astype(np.int32)
    feats = rng.uniform(0, 1, (10, 16, 2)).astype(np.float32)
    t = pipeline.Dataset(pts, labels, feats, task="cls", num_classes=4)
    j = jpipeline.Dataset(pts, labels, feats, task="cls", num_classes=4)
    for kw in (dict(shuffle=False, drop_last=False),
               dict(seed=3, drop_last=False), dict(seed=5)):
        tb, jb = list(t.batches(4, **kw)), list(j.batches(4, **kw))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batches = list(t.batches(4, shuffle=False, drop_last=False))
    np.testing.assert_array_equal(batches[2]["example_mask"],
                                  [True, True, False, False])
    assert int(sum(b["example_mask"].sum() for b in batches)) == 10
    dev = pipeline.to_device(batches[0], "cpu")
    assert {k: v.dtype for k, v in dev.items()} == {
        "xyz": torch.float32, "feat": torch.float32, "mask": torch.bool,
        "label": torch.int64, "example_mask": torch.bool}
    np.testing.assert_array_equal(dev["label"].numpy(), batches[0]["label"])
    assert pipeline.to_device(dev, "cpu")["xyz"] is dev["xyz"]


def test_unknown_dataset_falls_back_like_jax(tmp_path):
    """A real-dataset config without its files falls back to the hermetic
    synthetic split (64 train, 32 test), as in the JAX package."""
    check_make_dataset(tmp_path, dataset="scannet", num_points=128,
                       num_classes=21)
    check_make_dataset(tmp_path, task="cls", num_classes=40,
                       dataset="modelnet40", num_points=128)
    d = dataclasses.replace(DataConfig(), dataset="s3dis",
                            root=str(tmp_path), num_points=64, num_feats=6)
    assert pipeline.make_dataset(d, "test", 13, "seg").size == 32
