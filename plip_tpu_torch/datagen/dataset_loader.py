"""Validation-dataset CSV writers: the port's copy of
``plip_tpu.datagen.dataset_loader`` (the reference harness's
``generate_validation_datasets/_dataset_loader.py:10-248``).

Same prompt engineering ('An H&E image patch of [].'), label dictionaries, and
split protocols. The reference's DigestPath function computes a carefully
balanced per-WSI split and then immediately overwrites it with a random row
split (_dataset_loader.py:141-162); here the balanced per-sample split is
kept (``balanced_split=False`` restores the overwriting behavior for
bit-parity runs). numpy, PIL and pandas only; pandas is imported inside the
functions that need it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

opj = os.path.join

KATHER_SUBTYPES = {
    "ADI": "adipose tissue",
    "BACK": "background",
    "DEB": "debris",
    "LYM": "lymphocytes",
    "MUC": "mucus",
    "MUS": "smooth muscle",
    "NORM": "normal colon mucosa",
    "STR": "cancer-associated stroma",
    "TUM": "colorectal adenocarcinoma epithelium",
}


def prompt_engineering(text: str = "", template: str = "An H&E image patch of [].") -> str:
    return template.replace("[]", text)


def _add_style4(df, by_col, values, template):
    import pandas as pd

    out = pd.DataFrame()
    for subtype in values:
        sub = df.loc[df[by_col] == subtype].copy()
        sub["text_style_4"] = prompt_engineering(
            KATHER_SUBTYPES.get(subtype, subtype), template
        )
        out = pd.concat([out, sub], axis=0)
    return out.reset_index(drop=True)


def process_Kather_csv(
    root_dir: str, seed: Optional[int] = None, reroot: bool = True
) -> Tuple:
    """Kather/CRC-100K: 9-subtype prompts from the 100K train / 7K val CSVs.

    The published CSVs carry absolute paths from the authors' cluster; the
    reference remaps them onto ``root_dir`` by splitting at the
    ``pathtweets/`` tree marker (_dataset_loader.py:33-34). ``reroot=True``
    reproduces that remapping for any path containing the marker; paths
    without it (CSVs regenerated locally) pass through unchanged, and
    ``reroot=False`` disables remapping entirely.
    """
    import pandas as pd

    train_csv = opj(root_dir, "data_validation", "Kather_100K_Colon",
                    "image_fullpath_text_pair_100K.csv")
    test_csv = opj(root_dir, "data_validation", "Kather_100K_Colon",
                   "image_fullpath_text_pair_7K_validation.csv")

    def reroot_path(v: str) -> str:
        if reroot and "pathtweets/" in v:
            return root_dir.rstrip("/") + "/" + v.split("pathtweets/")[1]
        return v

    def process_csv(path2csv):
        df = pd.read_csv(path2csv)
        df = df[["image_fullpath", "label"]]
        df.columns = ["image", "label"]
        df["image"] = [reroot_path(v) for v in df["image"]]
        df["label_text"] = [KATHER_SUBTYPES[v] for v in df["label"]]
        return _add_style4(df, "label", KATHER_SUBTYPES.keys(),
                           "An H&E image patch of [].")

    return process_csv(train_csv), process_csv(test_csv)


def process_WSSS4LUAD_binary(root_dir: str, seed: int, train_ratio: float) -> Tuple:
    """WSSS4LUAD multi-label filenames '...[T, S, N]...' -> binary tumor."""
    import pandas as pd
    from PIL import Image

    path2data = opj(root_dir, "data_validation", "WSSS4LUAD", "1.training", "1.training")
    lbl2text = {0: "normal", 1: "tumor"}
    rows = []
    for file in sorted(os.listdir(path2data)):
        image_fullpath = opj(path2data, file)
        class_ = np.array(file.split("[")[1].split("]")[0].split(", ")).astype(int)
        lbl = 1 if class_[0] == 1 else 0
        try:
            Image.open(image_fullpath)
        except Exception:
            print(f"Image {file} cannot open. skip loading.")
            continue
        rows.append({"image": image_fullpath, "label": lbl, "label_text": lbl2text[lbl]})
    df = pd.DataFrame(rows)
    df = df.sample(frac=1, random_state=seed).reset_index(drop=True)
    n_train = int(len(df) * train_ratio)
    df_train, df_test = df.iloc[:n_train], df.iloc[n_train:]

    def fin(d):
        return _add_style4(d.reset_index(drop=True), "label_text",
                           ["tumor", "normal"], "An H&E image patch of [] tissue.")

    return fin(df_train), fin(df_test)


def process_DigestPath(
    root_dir: str, seed: Optional[int] = None, train_ratio: Optional[float] = None,
    balanced_split: bool = True,
) -> Tuple:
    """DigestPath step-2 outputs -> balanced binary CSVs."""
    import pandas as pd

    dd = opj(
        root_dir, "data_validation", "DigestPath2019",
        "Colonoscopy_tissue_segment_dataset", "processed",
        "cropsize=224_overlap=0.10_nonbgthreshold=0.50_downsamplelist=[2, 4, 8, 16, 32]",
        "step_2_tumor2patch_ratio_threshold=0.30",
    )
    neg = pd.read_csv(opj(dd, "final_negative_stats.csv"), index_col=0)
    pos = pd.read_csv(opj(dd, "final_positive_stats.csv"), index_col=0)

    def build(stats, cls, label, label_text):
        d = pd.DataFrame()
        d["image"] = [
            opj(dd, "images", cls, "%05d.png" % i) for i in range(len(stats))
        ]
        d["label"] = label
        d["label_text"] = label_text
        d["filename"] = [str(v) for v in stats["filename"]] if "filename" in stats else [
            "%05d" % v for v in stats.index
        ]
        return d

    df_neg = build(neg, "negative", 0, "benign")
    df_pos = build(pos, "positive", 1, "malignant")
    df = pd.concat([df_neg, df_pos], axis=0).reset_index(drop=True)

    rng = np.random.default_rng(seed)
    if balanced_split:
        # per-WSI split, balanced within each class (the intent of
        # _dataset_loader.py:124-139 before the overwrite bug)
        def split_samples(d):
            uniq = d["filename"].unique().copy()
            rng.shuffle(uniq)
            cut = int(len(uniq) * train_ratio)
            return set(uniq[:cut])

        train_names = split_samples(df_neg) | split_samples(df_pos)
        train_idx = df["filename"].isin(train_names)
        df_train = df.loc[train_idx].reset_index(drop=True)
        df_test = df.loc[~train_idx].reset_index(drop=True)
    else:
        # the reference's actual (overwriting) behavior: random row split
        df = df.sample(frac=1, random_state=seed).reset_index(drop=True)
        n_train = int(len(df) * train_ratio)
        df_train, df_test = (
            df.iloc[:n_train].reset_index(drop=True),
            df.iloc[n_train:].reset_index(drop=True),
        )

    def fin(d):
        return _add_style4(
            d[["image", "label", "label_text"]], "label_text",
            ["benign", "malignant"], "An H&E image patch of [] tissue.",
        )

    return fin(df_train), fin(df_test)


def process_PanNuke(
    csv_path: str, seed: Optional[int] = None, train_ratio: Optional[float] = None
) -> Tuple:
    """PanNuke binary CSV -> caption-parsed, per-tissue stratified split.

    csv_path points at the ``PanNuke_all_binary.csv`` written by
    datagen/preprocess_pannuke.py (the reference hardcodes its cluster path,
    _dataset_loader.py:183).
    """
    import pandas as pd

    df = pd.read_csv(csv_path, index_col=0).reset_index(drop=True)
    for i in df.index:
        caption = df.loc[i, "caption"]
        for label, label_text in [(1, "malignant"), (0, "benign")]:
            tag = f"{label_text} "
            if tag in caption:
                tissue = caption.split(tag)[1].split(" tissue")[0]
                df.loc[i, "tissue"] = tissue
                df.loc[i, "label"] = label
                df.loc[i, "label_text"] = label_text
                df.loc[i, "label_tissue"] = f"{label_text} {tissue}"
                df.loc[i, "caption_no_tissue"] = caption.replace(tissue + " ", "")
                break
        else:
            print(caption)

    df = df.sample(frac=1, random_state=seed).reset_index(drop=True)
    train = pd.DataFrame()
    test = pd.DataFrame()
    for tissue in df["tissue"].unique():
        for label_text in ["benign", "malignant"]:
            sub = df.loc[(df["tissue"] == tissue) & (df["label_text"] == label_text)]
            sub = sub.sample(frac=1, random_state=seed).reset_index(drop=True)
            cut = int(len(sub) * train_ratio)
            train = pd.concat([train, sub.iloc[:cut]], axis=0)
            test = pd.concat([test, sub.iloc[cut:]], axis=0)

    cols = ["image", "label", "label_text", "label_tissue", "caption", "caption_no_tissue"]
    new_cols = ["image", "label", "label_text", "text_style_0", "text_style_1", "text_style_4"]
    train = train.reset_index(drop=True)[cols]
    test = test.reset_index(drop=True)[cols]
    train.columns = new_cols
    test.columns = new_cols
    return train, test


def process_KIMIA_Path24(root_dir: str, seed: Optional[int] = None):
    """KIMIA Path24C test patches (test-only, _dataset_loader.py:237-247)."""
    import pandas as pd

    test_folder = opj(root_dir, "data_validation", "KIMIA_Path24C", "Test-patches")
    data = []
    for label in sorted(os.listdir(test_folder)):
        for jpg in sorted(os.listdir(opj(test_folder, label))):
            data.append((opj(test_folder, label, jpg), label))
    return pd.DataFrame(data, columns=["image", "label"])
