"""DigestPath WSI -> patch pipeline: the port's copy of
``plip_tpu.datagen.preprocess_digestpath`` (the reference harness's
``preprocess/preprocess_DigestPath.py:28-311``).

3 steps, same hyperparameters and thresholds:
1. multi-downsample [2,4,8,16,32] sliding-window 224 crops, overlap 0.1,
   background = all-RGB>=200 mask, keep tissue>=50%
2. tumor2patch-ratio thresholding (pos >= threshold, neg == 0), merging
   negatives from both sources
3. npy stacks -> per-patch pngs named {wsi}_downsample={d}_{i:05d}.png

``background_ratio`` is also the rule the streaming WSI pipeline
(``data/wsi.py``) filters tiles by.

    python -m plip_tpu_torch.datagen.preprocess_digestpath --step 1|2|3 --workdir DIR
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

opj = os.path.join


def background_ratio(rgb: np.ndarray, threshold: int = 200) -> float:
    """Fraction of pixels with all channels >= threshold
    (preprocess_DigestPath.py:28-34)."""
    bg_mask = (
        (rgb[..., 0] >= threshold)
        & (rgb[..., 1] >= threshold)
        & (rgb[..., 2] >= threshold)
    )
    return float(np.sum(bg_mask)) / (rgb.shape[0] * rgb.shape[1])


def sliding_crop(
    img,
    msk=None,
    downsample: int = 1,
    cropsize: int = 224,
    crop_overlap: float = 0.1,
    non_bg_threshold: float = 0.5,
):
    """Downsample a WSI and harvest tissue patches on a strided grid.

    Returns (patches [N,c,c,3] uint8, stats DataFrame) or (None, None).
    (The reference names this ``random_crop`` though it is deterministic —
    preprocess_DigestPath.py:37-108.)
    """
    import pandas as pd
    from PIL import Image

    new_size = (
        int(np.round(img.size[0] / downsample)),
        int(np.round(img.size[1] / downsample)),
    )
    img = img.resize(new_size)
    if img.size[0] < cropsize or img.size[1] < cropsize:
        return None, None

    img_np = np.array(img)
    msk_np = None
    if msk is not None:
        msk = msk.resize(new_size, Image.Resampling.NEAREST)
        # jpg-compressed masks aren't binary; binarize at >10
        msk_np = (np.array(msk) > 10).astype(int)

    stride = cropsize * (1 - crop_overlap)
    x_list = np.arange(0, img_np.shape[0], stride).astype(int)
    y_list = np.arange(0, img_np.shape[1], stride).astype(int)

    imgs_all, tissue_all, t2p_all, t2t_all = [], [], [], []
    for x1 in x_list:
        for y1 in y_list:
            x2, y2 = x1 + cropsize, y1 + cropsize
            if x2 >= img_np.shape[0] or y2 >= img_np.shape[1]:
                continue
            patch = img_np[x1:x2, y1:y2, :]
            tissue_ratio = 1.0 - background_ratio(patch)
            if tissue_ratio < non_bg_threshold:
                continue
            if msk_np is not None:
                mpatch = msk_np[x1:x2, y1:y2]
                area = mpatch.shape[0] * mpatch.shape[1]
                t2p = np.sum(mpatch > 0) / area
                t2t = np.sum(mpatch > 0) / (area * tissue_ratio)
            else:
                t2p = t2t = 0.0
            imgs_all.append(patch)
            tissue_all.append(tissue_ratio)
            t2p_all.append(t2p)
            t2t_all.append(t2t)

    if not imgs_all:
        return None, None
    stats = pd.DataFrame(
        np.c_[tissue_all, t2p_all, t2t_all],
        columns=["tissue_ratio", "tumor_to_patch_ratio", "tumor_to_tissue_ratio"],
    )
    stats["downsample"] = downsample
    stats["cropsize"] = cropsize
    stats["crop_overlap"] = crop_overlap
    stats["non_bg_threshold"] = non_bg_threshold
    return np.stack(imgs_all), stats


# keep the reference's name as an alias
random_crop = sliding_crop


def run_step_1(
    path2pos: str,
    path2neg: str,
    resultdir: str,
    cropsize: int = 224,
    crop_overlap: float = 0.1,
    non_bg_threshold: float = 0.5,
    downsample_list: List[int] = (2, 4, 8, 16, 32),
) -> None:
    """Harvest patches from positive (with *_mask.jpg) and negative WSIs."""
    import pandas as pd
    from PIL import Image

    os.makedirs(resultdir, exist_ok=True)

    def harvest(path, with_mask):
        names = np.sort([v for v in os.listdir(path) if not v.endswith("_mask.jpg")])
        all_imgs, all_stats = [], []
        for fname in names:
            uniq = fname.rsplit(".", 1)[0]
            img = Image.open(opj(path, fname))
            msk = None
            if with_mask:
                mask_name = fname.replace(".jpg", "_mask.jpg")
                if os.path.exists(opj(path, mask_name)):
                    msk = Image.open(opj(path, mask_name))
            for downsample in downsample_list:
                imgs, stats = sliding_crop(
                    img, msk, downsample, cropsize, crop_overlap, non_bg_threshold
                )
                if imgs is None:
                    continue
                stats["filename"] = uniq
                stats["downsample"] = downsample
                all_imgs.append(imgs)
                all_stats.append(stats)
        if not all_imgs:
            return None, None
        return (
            np.concatenate(all_imgs, axis=0),
            pd.concat(all_stats, axis=0).reset_index(drop=True),
        )

    pos_imgs, pos_stats = harvest(path2pos, with_mask=True)
    neg_imgs, neg_stats = harvest(path2neg, with_mask=False)
    if pos_imgs is not None:
        np.save(opj(resultdir, "imgs_from_pos_v1.npy"), pos_imgs)
        pos_stats.to_csv(opj(resultdir, "stat_from_pos_v1.csv"))
    if neg_imgs is not None:
        np.save(opj(resultdir, "imgs_from_neg.npy"), neg_imgs)
        neg_stats.to_csv(opj(resultdir, "stat_from_neg.csv"))


def run_step_2(
    step_1_resultdir: str,
    step_2_resultdir: str,
    tumor2patch_ratio_threshold: float = 0.5,
) -> None:
    """Threshold patches into final positives/negatives
    (preprocess_DigestPath.py:256-273)."""
    import pandas as pd

    os.makedirs(step_2_resultdir, exist_ok=True)
    imgs_neg = np.load(opj(step_1_resultdir, "imgs_from_neg.npy"))
    stat_neg = pd.read_csv(opj(step_1_resultdir, "stat_from_neg.csv"), index_col=0)
    imgs_pos = np.load(opj(step_1_resultdir, "imgs_from_pos_v1.npy"))
    stat_pos = pd.read_csv(opj(step_1_resultdir, "stat_from_pos_v1.csv"), index_col=0)

    pos_index = stat_pos["tumor_to_patch_ratio"].values >= tumor2patch_ratio_threshold
    neg_index = stat_pos["tumor_to_patch_ratio"].values == 0

    final_neg = np.concatenate([imgs_neg, imgs_pos[neg_index]], axis=0)
    final_neg_stats = pd.concat(
        [stat_neg, stat_pos.loc[neg_index]], axis=0
    ).reset_index(drop=True)
    final_pos = imgs_pos[pos_index]
    final_pos_stats = stat_pos.loc[pos_index].reset_index(drop=True)

    np.save(opj(step_2_resultdir, "final_negative_images.npy"), final_neg)
    final_neg_stats.to_csv(opj(step_2_resultdir, "final_negative_stats.csv"))
    np.save(opj(step_2_resultdir, "final_positive_images.npy"), final_pos)
    final_pos_stats.to_csv(opj(step_2_resultdir, "final_positive_stats.csv"))


def run_step_3(step_2_resultdir: str) -> None:
    """Unstack npy stacks to pngs (preprocess_DigestPath.py:276-309)."""
    import pandas as pd
    from PIL import Image

    for cls, img_file, stat_file in [
        ("negative", "final_negative_images.npy", "final_negative_stats.csv"),
        ("positive", "final_positive_images.npy", "final_positive_stats.csv"),
    ]:
        imgs = np.load(opj(step_2_resultdir, img_file))
        stats = pd.read_csv(opj(step_2_resultdir, stat_file), index_col=0)
        outdir = opj(step_2_resultdir, "images", cls)
        os.makedirs(outdir, exist_ok=True)
        for i in range(len(imgs)):
            filename = stats.iloc[i]["filename"]
            downsample = stats.iloc[i]["downsample"]
            Image.fromarray(imgs[i]).save(
                opj(outdir, "%s_downsample=%d_%05d.png" % (filename, downsample, i))
            )


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--step", type=int, required=True, choices=[1, 2, 3])
    p.add_argument("--workdir", required=True)
    p.add_argument("--tumor2patch_ratio_threshold", type=float, default=0.5)
    args = p.parse_args()

    dd = opj(args.workdir, "data_validation", "DigestPath2019",
             "Colonoscopy_tissue_segment_dataset")
    cropsize, crop_overlap, non_bg_threshold = 224, 0.1, 0.5
    downsample_list = [2, 4, 8, 16, 32]
    base = opj(
        dd, "processed",
        "cropsize=%d_overlap=%.2f_nonbgthreshold=%.2f_downsamplelist=%s"
        % (cropsize, crop_overlap, non_bg_threshold, str(downsample_list)),
    )
    step1_dir = opj(base, "step_1")
    step2_dir = opj(
        base,
        "step_2_tumor2patch_ratio_threshold=%.2f" % args.tumor2patch_ratio_threshold,
    )
    if args.step == 1:
        run_step_1(opj(dd, "tissue-train-pos-v1"), opj(dd, "tissue-train-neg"),
                   step1_dir, cropsize, crop_overlap, non_bg_threshold, downsample_list)
    elif args.step == 2:
        run_step_2(step1_dir, step2_dir, args.tumor2patch_ratio_threshold)
    else:
        run_step_3(step2_dir)
    print("All done.")
