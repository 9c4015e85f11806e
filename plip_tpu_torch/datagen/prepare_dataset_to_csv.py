"""Offline tile resizing and the CSV manifest writer: the port's copy of
``plip_tpu.datagen.prepare_dataset_to_csv`` (the reference harness's
``generate_validation_datasets/prepare_dataset_to_csv.py:19-168``).

``parmap`` is a process pool; ``resizeimg`` keeps the shortest-side-
scale-to-224 + center-crop semantics, with the reference's crop-coordinate
bug fixed (prepare_dataset_to_csv.py:53-58 computes the crop box from the
PRE-resize width/height, producing out-of-bounds crops PIL pads with black;
here the box comes from the resized dims).

    python -m plip_tpu_torch.datagen.prepare_dataset_to_csv --root_dir RAW \
        --img_savedir IMGS --savedir CSVS [--pannuke_csv CSV]
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import Callable, List, Sequence

opj = os.path.join


def parmap(f: Callable, X: Sequence, nprocs: int = None) -> List:
    """Order-preserving parallel map over processes
    (prepare_dataset_to_csv.py:19-37's queue machinery, stdlib-ified)."""
    nprocs = nprocs or os.cpu_count()
    with ProcessPoolExecutor(max_workers=nprocs) as pool:
        return list(pool.map(f, X))


def resizeimg(fp: str, this_savedir: str, newsize: int = 224) -> str:
    """Shortest-side scale to ``newsize`` then center crop; square images are
    resized directly (prepare_dataset_to_csv.py:40-63)."""
    from PIL import Image

    img = Image.open(fp)
    filename = os.path.basename(fp)
    if img.size[0] != img.size[1]:
        width, height = img.size
        min_dimension = min(width, height)
        scale_factor = newsize / min_dimension
        new_width = int(width * scale_factor)
        new_height = int(height * scale_factor)
        img = img.resize((new_width, new_height))
        # crop box from the RESIZED dims (reference uses pre-resize dims — bug)
        left = (new_width - newsize) / 2
        top = (new_height - newsize) / 2
        img_resize = img.crop((left, top, left + newsize, top + newsize))
    else:
        img_resize = img.resize((newsize, newsize))
    new_savename = opj(this_savedir, filename)
    img_resize.save(new_savename)
    return new_savename


def resize_split(df, savedir_imgs: str, nprocs: int = None, newsize: int = 224):
    """Resize every image in df['image'] into savedir_imgs; returns df with
    updated paths."""
    os.makedirs(savedir_imgs, exist_ok=True)
    new_paths = parmap(
        partial(resizeimg, this_savedir=savedir_imgs, newsize=newsize),
        list(df["image"]),
        nprocs=nprocs,
    )
    df = df.copy()
    df["image"] = new_paths
    return df


def prepare_all(
    root_dir: str,
    img_savedir: str,
    savedir: str,
    pannuke_csv: str = None,
    seed: int = 1,
    train_ratio: float = 0.7,
    nprocs: int = None,
):
    """Run the full pipeline for every dataset present under root_dir,
    writing ``{dataset}_{train,test}.csv`` (prepare_dataset_to_csv.py:65-168).
    Datasets whose raw inputs are missing are skipped with a notice."""
    from . import dataset_loader as dl

    os.makedirs(img_savedir, exist_ok=True)
    os.makedirs(savedir, exist_ok=True)

    jobs = {
        "Kather": lambda: dl.process_Kather_csv(root_dir),
        "PanNuke": lambda: dl.process_PanNuke(pannuke_csv, seed=seed, train_ratio=train_ratio),
        "DigestPath": lambda: dl.process_DigestPath(root_dir, seed=seed, train_ratio=train_ratio),
        "WSSS4LUAD_binary": lambda: dl.process_WSSS4LUAD_binary(root_dir, seed=seed, train_ratio=train_ratio),
    }
    written = []
    for name, job in jobs.items():
        try:
            train, test = job()
        except (FileNotFoundError, TypeError, ValueError, OSError) as e:
            print(f"Skipping {name}: {e}")
            continue
        print(f"Processing {name} dataset ...")
        train = resize_split(train, opj(img_savedir, name, "train"), nprocs)
        test = resize_split(test, opj(img_savedir, name, "test"), nprocs)
        train.to_csv(opj(savedir, f"{name}_train.csv"))
        test.to_csv(opj(savedir, f"{name}_test.csv"))
        written.append(name)

    try:
        kimia_test = dl.process_KIMIA_Path24(root_dir, seed=seed)
        kimia_test = resize_split(kimia_test, opj(img_savedir, "KIMIA_Path24", "test"), nprocs)
        kimia_test.to_csv(opj(savedir, "KIMIA_Path24_test.csv"))
        written.append("KIMIA_Path24")
    except (FileNotFoundError, OSError) as e:
        print(f"Skipping KIMIA_Path24: {e}")
    return written


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--root_dir", required=True)
    p.add_argument("--img_savedir", required=True)
    p.add_argument("--savedir", required=True)
    p.add_argument("--pannuke_csv", default=None)
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--train_ratio", default=0.7, type=float)
    args = p.parse_args()
    prepare_all(
        args.root_dir, args.img_savedir,
        opj(args.savedir, "trainratio=%.2f_size=224" % args.train_ratio),
        pannuke_csv=args.pannuke_csv, seed=args.seed, train_ratio=args.train_ratio,
    )
