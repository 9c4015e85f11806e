"""PanNuke fold preprocessing: the port's copy of
``plip_tpu.datagen.preprocess_pannuke`` (the reference harness's
``preprocess/preprocess_PanNuke.py:16-111``).

Pipeline: concat 3 folds of (images, masks, types) npys; drop pure-background
images; count nuclei per class via unique mask instance ids; malignant =
>=min_tumor_cells neoplastic AND >tumor_frac of all cells; benign = 0
neoplastic; write pngs + caption CSV
``'An H&E image of {malignant|benign} {tissue} tissue.'``.

    python -m plip_tpu_torch.datagen.preprocess_pannuke --data_dir PANNUKE
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

opj = os.path.join


def load_folds(dd: str):
    """Concat folds 1-3 (preprocess_PanNuke.py:19-35)."""
    imgs, msks, typs = [], [], []
    for i in (1, 2, 3):
        base = opj(dd, f"fold_{i}", f"Fold {i}")
        imgs.append(np.load(opj(base, "images", f"fold{i}", "images.npy")).astype(np.uint8))
        msks.append(np.load(opj(base, "masks", f"fold{i}", "masks.npy")).astype(np.uint8))
        typs.append(np.load(opj(base, "images", f"fold{i}", "types.npy")))
    return (
        np.concatenate(imgs, axis=0),
        np.concatenate(msks, axis=0),
        np.concatenate(typs, axis=0),
    )


def drop_pure_background(imgs, msks, typs):
    """Drop images whose first 5 mask channels are all zero
    (preprocess_PanNuke.py:40-45)."""
    idx = np.sum(msks[..., 0:5].reshape(len(msks), -1), axis=1) == 0
    return imgs[~idx], msks[~idx], typs[~idx]


def count_nuclei(msks) -> np.ndarray:
    """[N, 6] per-class nucleus counts: number of unique non-zero instance ids
    per channel (preprocess_PanNuke.py:57-61)."""
    n = len(msks)
    counts = np.zeros((n, 6), dtype=np.int64)
    flat = msks.reshape(n, -1, msks.shape[-1])
    for i in range(n):
        for j in range(6):
            counts[i, j] = len(np.unique(flat[i, :, j])) - 1
    return counts


def classify(
    counts: np.ndarray, min_tumor_cells: int = 10, tumor_frac: float = 0.3
) -> Tuple[np.ndarray, np.ndarray]:
    """(tumor_idx, benign_idx) boolean masks (preprocess_PanNuke.py:67-74).
    Class 0 = neoplastic cells."""
    total = counts.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total > 0, counts[:, 0] / np.maximum(total, 1), 0.0)
    tumor_idx = (counts[:, 0] >= min_tumor_cells) & (frac > tumor_frac)
    benign_idx = counts[:, 0] == 0
    return tumor_idx, benign_idx


def write_outputs(
    imgs_malignant, typs_malignant, imgs_benign, typs_benign, outdir: str
) -> str:
    """Write pngs + PanNuke_all_binary.csv (preprocess_PanNuke.py:85-111)."""
    import pandas as pd
    from PIL import Image

    savedir = opj(outdir, "images")
    os.makedirs(savedir, exist_ok=True)
    rows = []
    for label_text, imgs, typs in [
        ("malignant", imgs_malignant, typs_malignant),
        ("benign", imgs_benign, typs_benign),
    ]:
        for i in range(len(imgs)):
            tissue = str(typs[i]).lower().replace("_", " ")
            fname = "%s_%s_%04d.png" % (tissue, label_text, i)
            Image.fromarray(imgs[i]).save(opj(savedir, fname))
            rows.append(
                {
                    "image": opj(savedir, fname),
                    "caption": f"An H&E image of {label_text} {tissue} tissue.",
                }
            )
    df = pd.DataFrame(rows)
    csv_path = opj(outdir, "PanNuke_all_binary.csv")
    df.to_csv(csv_path)
    return csv_path


def main(dd: str, min_tumor_cells: int = 10, tumor_frac: float = 0.3) -> str:
    imgs, msks, typs = load_folds(dd)
    imgs, msks, typs = drop_pure_background(imgs, msks, typs)
    counts = count_nuclei(msks)
    tumor_idx, benign_idx = classify(counts, min_tumor_cells, tumor_frac)
    outdir = opj(dd, f"processed_threshold={min_tumor_cells}_{tumor_frac}")
    return write_outputs(
        imgs[tumor_idx], typs[tumor_idx], imgs[benign_idx], typs[benign_idx], outdir
    )


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True, help="PanNuke root with fold_{1,2,3}")
    p.add_argument("--min_tumor_cells", type=int, default=10)
    p.add_argument("--tumor_frac", type=float, default=0.3)
    args = p.parse_args()
    print(main(args.data_dir, args.min_tumor_cells, args.tumor_frac))
