"""The port's dataset generation helpers against the JAX package's (CPU).

``plip_tpu_torch.datagen`` is a copy of ``plip_tpu.datagen`` (numpy, PIL,
pandas). The cases of ``tests/test_datagen.py`` and
``tests/test_datagen_driver.py::test_prepare_all_with_wsss_only`` run on
both copies with the same seeded inputs, each in a folder of its own, and
the outputs are held equal: the crops and arrays bit for bit, the CSVs and
DataFrames cell for cell (paths compared below their package's folder), the
counts and PNGs pixel for pixel.
"""

import os

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pd = pytest.importorskip("pandas")
from PIL import Image  # noqa: E402

from plip_tpu.datagen import dataset_loader as jdl  # noqa: E402
from plip_tpu.datagen import prepare_dataset_to_csv as jprep  # noqa: E402
from plip_tpu.datagen import preprocess_digestpath as jdp  # noqa: E402
from plip_tpu.datagen import preprocess_pannuke as jpn  # noqa: E402
from plip_tpu_torch.datagen import dataset_loader as tdl  # noqa: E402
from plip_tpu_torch.datagen import prepare_dataset_to_csv as tprep  # noqa: E402
from plip_tpu_torch.datagen import preprocess_digestpath as tdp  # noqa: E402
from plip_tpu_torch.datagen import preprocess_pannuke as tpn  # noqa: E402

opj = os.path.join


def _rel(df, root):
    """``df`` with every path under ``root`` made relative to it."""
    df = df.copy()
    for c in df.columns:
        if any(isinstance(v, str) for v in df[c]):
            df[c] = df[c].map(lambda v: v.replace(str(root), "<root>")
                              if isinstance(v, str) else v)
    return df


def _same_frames(a, b, root_a=None, root_b=None):
    if root_a is not None:
        a, b = _rel(a, root_a), _rel(b, root_b)
    pd.testing.assert_frame_equal(a, b)


def _same_pngs(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(opj(dir_a, n))),
                                      np.asarray(Image.open(opj(dir_b, n))))


@pytest.mark.parametrize("text,template", [("debris", "An H&E image patch of []."),
                                           ("tumor", "An H&E image patch of [] tissue.")])
def test_prompt_engineering(text, template):
    assert tdl.prompt_engineering(text, template) == jdl.prompt_engineering(text, template)
    assert tdl.prompt_engineering("debris") == "An H&E image patch of debris."
    assert tdl.KATHER_SUBTYPES == jdl.KATHER_SUBTYPES


def test_background_ratio():
    rng = np.random.default_rng(0)
    white = np.full((10, 10, 3), 255, np.uint8)
    dark = np.full((10, 10, 3), 50, np.uint8)
    for arr in (white, dark, np.concatenate([white[:5], dark[:5]]),
                rng.integers(150, 256, (33, 17, 3), dtype=np.uint8)):
        for thr in (200, 180):
            assert tdp.background_ratio(arr, thr) == jdp.background_ratio(arr, thr)
    assert tdp.background_ratio(np.concatenate([white[:5], dark[:5]])) == 0.5


def test_sliding_crop_counts_and_filtering():
    rng = np.random.default_rng(0)
    arr = rng.integers(50, 150, (512, 512, 3), dtype=np.uint8)
    arr[:, 300:] = 255
    img = Image.fromarray(arr)
    kw = dict(downsample=1, cropsize=224, crop_overlap=0.5, non_bg_threshold=0.5)
    got, got_stats = tdp.sliding_crop(img, None, **kw)
    want, want_stats = jdp.sliding_crop(img, None, **kw)
    np.testing.assert_array_equal(got, want)
    _same_frames(got_stats, want_stats)
    assert got.shape[1:] == (224, 224, 3) and (got_stats["tissue_ratio"] >= 0.5).all()
    assert tdp.sliding_crop(img, None, downsample=4, cropsize=224) == (None, None)
    assert tdp.random_crop is tdp.sliding_crop


def test_sliding_crop_with_mask_ratios():
    arr = np.full((512, 512, 3), 100, np.uint8)
    msk = np.zeros((512, 512), np.uint8)
    msk[:, :256] = 255
    kw = dict(downsample=1, cropsize=224, crop_overlap=0.0, non_bg_threshold=0.5)
    got, got_stats = tdp.sliding_crop(Image.fromarray(arr), Image.fromarray(msk), **kw)
    want, want_stats = jdp.sliding_crop(Image.fromarray(arr), Image.fromarray(msk), **kw)
    np.testing.assert_array_equal(got, want)
    _same_frames(got_stats, want_stats)
    assert got_stats["tumor_to_patch_ratio"].max() > 0.9
    assert got_stats["tumor_to_patch_ratio"].min() < 0.3


def test_digestpath_steps_end_to_end(tmp_path):
    rng = np.random.default_rng(1)
    pos, neg = tmp_path / "pos", tmp_path / "neg"
    pos.mkdir()
    neg.mkdir()
    Image.fromarray(rng.integers(60, 160, (700, 700, 3), dtype=np.uint8)).save(pos / "wsi1.jpg")
    m = np.zeros((700, 700), np.uint8)
    m[:, :350] = 255
    Image.fromarray(m).save(pos / "wsi1_mask.jpg")
    Image.fromarray(rng.integers(60, 160, (700, 700, 3), dtype=np.uint8)).save(neg / "wsi2.jpg")

    for pkg, tag in ((tdp, "port"), (jdp, "jax")):
        s1, s2 = str(tmp_path / tag / "step1"), str(tmp_path / tag / "step2")
        pkg.run_step_1(str(pos), str(neg), s1, cropsize=224, crop_overlap=0.1,
                       non_bg_threshold=0.5, downsample_list=[1, 2])
        pkg.run_step_2(s1, s2, tumor2patch_ratio_threshold=0.5)
        pkg.run_step_3(s2)
    for step, files in (("step1", ("imgs_from_pos_v1.npy", "imgs_from_neg.npy")),
                        ("step2", ("final_positive_images.npy",
                                   "final_negative_images.npy"))):
        for f in files:
            np.testing.assert_array_equal(np.load(tmp_path / "port" / step / f),
                                          np.load(tmp_path / "jax" / step / f))
        for f in os.listdir(tmp_path / "jax" / step):
            if f.endswith(".csv"):
                _same_frames(pd.read_csv(tmp_path / "port" / step / f, index_col=0),
                             pd.read_csv(tmp_path / "jax" / step / f, index_col=0))
    for cls in ("positive", "negative"):
        _same_pngs(tmp_path / "port" / "step2" / "images" / cls,
                   tmp_path / "jax" / "step2" / "images" / cls)
    assert all("downsample=" in f
               for f in os.listdir(tmp_path / "port" / "step2" / "images" / "positive"))


def test_pannuke_classify_and_outputs(tmp_path):
    n = 6
    msks = np.zeros((n, 32, 32, 6), np.uint8)
    for k in range(12):
        msks[0, k, :2, 0] = k + 1
    msks[1, 0, :2, 1] = 1
    for k in range(2):
        msks[3, k, :2, 0] = k + 1
    for k in range(30):
        msks[3, k, 4:6, 1] = k + 1
    msks[4, 0, :2, 2] = 1
    msks[5, 0, :2, 4] = 3
    imgs = np.random.default_rng(2).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    typs = np.array(["Breast", "Colon", "Skin", "Lung", "Breast", "Head_Neck"])

    out = {}
    for pkg, tag in ((tpn, "port"), (jpn, "jax")):
        i, m, t = pkg.drop_pure_background(imgs, msks, typs)
        counts = pkg.count_nuclei(m)
        tumor, benign = pkg.classify(counts, min_tumor_cells=10, tumor_frac=0.3)
        csv = pkg.write_outputs(i[tumor], t[tumor], i[benign], t[benign],
                                str(tmp_path / tag))
        out[tag] = (i, m, t, counts, tumor, benign, csv)
    for a, b in zip(out["port"][:6], out["jax"][:6]):
        np.testing.assert_array_equal(a, b)
    assert len(out["port"][0]) == 5 and out["port"][4].sum() == 1 and out["port"][5].sum() == 3
    got = pd.read_csv(out["port"][6], index_col=0)
    _same_frames(got, pd.read_csv(out["jax"][6], index_col=0),
                 tmp_path / "port", tmp_path / "jax")
    _same_pngs(tmp_path / "port" / "images", tmp_path / "jax" / "images")
    assert any("head neck" in c for c in got["caption"])
    for seed in (0, 3):
        for a, b in zip(tdl.process_PanNuke(out["port"][6], seed=seed, train_ratio=0.5),
                        jdl.process_PanNuke(out["jax"][6], seed=seed, train_ratio=0.5)):
            _same_frames(a, b, tmp_path / "port", tmp_path / "jax")


def _wsss_tree(root, shape=(64, 64, 3)):
    d = root / "data_validation" / "WSSS4LUAD" / "1.training" / "1.training"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, cls in enumerate(["[1, 0, 0]", "[0, 1, 0]", "[1, 1, 0]", "[0, 0, 1]"]):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            d / f"img_{i}_{cls}.png")


@pytest.mark.parametrize("seed,ratio", [(0, 0.5), (5, 0.75)])
def test_wsss4luad_loader(tmp_path, seed, ratio):
    _wsss_tree(tmp_path)
    got = tdl.process_WSSS4LUAD_binary(str(tmp_path), seed=seed, train_ratio=ratio)
    want = jdl.process_WSSS4LUAD_binary(str(tmp_path), seed=seed, train_ratio=ratio)
    for a, b in zip(got, want):
        _same_frames(a, b)
    assert set(pd.concat(got)["label"]) == {0, 1}


@pytest.mark.parametrize("shape", [(300, 600, 3), (600, 300, 3), (250, 250, 3)])
def test_resizeimg_center_crop(tmp_path, shape):
    arr = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    arr[:, shape[1] // 2 - 10:shape[1] // 2 + 10] = 255
    p = str(tmp_path / "x.png")
    Image.fromarray(arr).save(p)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = np.asarray(Image.open(tprep.resizeimg(p, str(tmp_path / "port"), newsize=224)))
    want = np.asarray(Image.open(jprep.resizeimg(p, str(tmp_path / "jax"), newsize=224)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (224, 224, 3) and got[:, 112].mean() > 200


def test_resize_split(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"in_{i}.png")
        Image.fromarray(rng.integers(0, 256, (100, 160, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    df = pd.DataFrame({"image": paths, "label": [0, 1, 0]})
    got = tprep.resize_split(df, str(tmp_path / "port"), nprocs=2)
    want = jprep.resize_split(df, str(tmp_path / "jax"), nprocs=2)
    _same_frames(got, want, tmp_path / "port", tmp_path / "jax")
    _same_pngs(tmp_path / "port", tmp_path / "jax")
    assert tprep.parmap(abs, [-1, 2, -3], nprocs=2) == [1, 2, 3]


def test_kather_reroot(tmp_path):
    root = tmp_path / "root"
    d = root / "data_validation" / "Kather_100K_Colon"
    d.mkdir(parents=True)
    cluster = "/oak/stanford/groups/xyz/pathtweets/data_validation/K/ADI-x.tif"
    local = str(root / "local" / "ADI-y.tif")
    for name in ("image_fullpath_text_pair_100K.csv",
                 "image_fullpath_text_pair_7K_validation.csv"):
        pd.DataFrame({"image_fullpath": [cluster, local, cluster.replace("ADI", "MUC")],
                      "label": ["ADI", "TUM", "MUC"]}).to_csv(d / name, index=False)
    for reroot in (True, False):
        got = tdl.process_Kather_csv(str(root), reroot=reroot)
        want = jdl.process_Kather_csv(str(root), reroot=reroot)
        for a, b in zip(got, want):
            _same_frames(a, b)
    assert str(root / "data_validation" / "K" / "ADI-x.tif") in set(got[0]["image"]) or \
        cluster in set(got[0]["image"])


def test_prepare_all_with_wsss_only(tmp_path):
    raw = tmp_path / "raw"
    _wsss_tree(raw, (100, 160, 3))
    written = {}
    for pkg, tag in ((tprep, "port"), (jprep, "jax")):
        written[tag] = pkg.prepare_all(str(raw), str(tmp_path / tag / "imgs"),
                                       str(tmp_path / tag / "csvs"), seed=1,
                                       train_ratio=0.5, nprocs=2)
    assert written["port"] == written["jax"] == ["WSSS4LUAD_binary"]
    for split in ("train", "test"):
        f = f"WSSS4LUAD_binary_{split}.csv"
        _same_frames(pd.read_csv(tmp_path / "port" / "csvs" / f, index_col=0),
                     pd.read_csv(tmp_path / "jax" / "csvs" / f, index_col=0),
                     tmp_path / "port", tmp_path / "jax")
        _same_pngs(tmp_path / "port" / "imgs" / "WSSS4LUAD_binary" / split,
                   tmp_path / "jax" / "imgs" / "WSSS4LUAD_binary" / split)
