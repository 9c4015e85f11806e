"""Bulk embedding extraction: the port of ``plip_tpu.scripts.extract_embedding``
(the reference harness's ``scripts/extract_embedding.py``, its dataset CSVs
read from ``$PC_EVALUATION_DATA_ROOT_FOLDER``), plus ``--device``.

Usage::

    python -m plip_tpu_torch.scripts.extract_embedding --dataset Kather_mini
        [--model_name plip] [--backbone default] [--batch-size 128] [--device cpu]

Writes under ``{PC_RESULTS_FOLDER}/embeddings/{dataset}`` the raw and
L2-normalized image and text ``.npy`` files (the reference's names), a
public CSV manifest, and the README note. An eval dataset is encoded by
``PLIP.encode_images`` (the tower's own preprocessing); OpenPath takes the
training crops: ``data.transform.TrainTransform`` (shortest side to
``--first_resize``, a random square crop) on the host, then
``ops.augment.augment_batch`` to ``--pxsize`` on the device, its draws from
a ``torch.Generator`` seeded with ``--random_seed`` (so the crops are not the
JAX package's, whose stream is JAX's). The model runs on ``--device``
(default: the CUDA device). pandas is imported inside ``main``.
"""

import argparse
import os

import numpy as np

from ..utils.config import load_dotenv_file

opj = os.path.join


def config(argv=None):
    load_dotenv_file(os.environ.get("PC_DOTENV", "../config.env"))
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="plip", type=str, choices=["plip", "clip"])
    parser.add_argument("--backbone", default="default", type=str)
    parser.add_argument("--dataset", default="OpenPath", type=str)
    parser.add_argument("--first_resize", default=512, type=int)
    parser.add_argument("--pxsize", default=224, type=int)
    parser.add_argument("--batch-size", default=128, type=int)
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="where the model runs (default: the CUDA device)")
    return parser.parse_args(argv)


def openpath_embeddings(model, images, args) -> np.ndarray:
    """Unnormalized image embeddings of the training crops: TrainTransform
    on the loader's threads, ``augment_batch`` and the image tower on the
    model's device."""
    import torch

    from ..data.datasets import ImageCaptionDataset
    from ..data.loader import PrefetchLoader
    from ..data.transform import TrainTransform
    from ..ops.augment import AugmentConfig, augment_batch

    t = TrainTransform(first_resize=args.first_resize, n_px=args.pxsize,
                       seed=args.random_seed)
    ds = ImageCaptionDataset({"image": list(images), "caption": [""] * len(images)},
                             preprocessing=t)
    loader = PrefetchLoader(ds, args.batch_size, num_workers=args.num_workers,
                            device=model.device)
    gen = torch.Generator().manual_seed(args.random_seed)
    aug = AugmentConfig(out_size=args.pxsize)
    outs = []
    for (batch, _), n in loader:
        pixels = augment_batch(gen, batch, aug)
        with torch.inference_mode():
            outs.append(model.model.encode_image(pixels, model.dtype)[:n].cpu().numpy())
    return np.concatenate(outs)


def extract_embedding(args, dataset_name, df):
    """(image_embeddings, text_embeddings), both unnormalized."""
    from ..api import PLIP

    np.random.seed(args.random_seed)

    if args.model_name == "plip" and args.backbone not in ("default", "", None):
        model = PLIP(args.backbone, device=args.device)
    else:
        arch = os.environ.get("PC_CLIP_ARCH", "ViT-B/32")
        ckpt = os.environ.get("PLIP_TPU_CHECKPOINT")
        model = PLIP(ckpt if ckpt else f"random:{arch}", device=args.device)

    images = df["image"].values.astype(str)
    if dataset_name == "OpenPath":
        print(f"Use train_preprocess: first resize to {args.first_resize}, then "
              f"{args.pxsize}x{args.pxsize} crops.")
        image_embeddings = openpath_embeddings(model, images, args)
    else:
        print("Use normal preprocess (the tower's eval pipeline).")
        image_embeddings = model.encode_images(list(images), batch_size=args.batch_size)

    text_embeddings = model.encode_text(
        list(df["caption"].values.astype(str)), batch_size=args.batch_size
    )
    return image_embeddings, text_embeddings


def main(argv=None):
    import pandas as pd

    args = config(argv)
    results_root = os.environ.get("PC_RESULTS_FOLDER", "./results")
    savepath = opj(results_root, "embeddings", args.dataset)
    os.makedirs(savepath, exist_ok=True)

    with open(opj(results_root, "embeddings", "README.md"), "w") as readme_file:
        readme_file.write("# Note\n\n")
        readme_file.write(
            "The image and text embeddings are saved in numpy binary files "
            "(```.npy```). The order of the embeddings corresponds to their "
            "associated ```.csv``` files.\n"
            "Both unnormalized and normalized formats are available for all "
            "embeddings.\n\n"
            "The normalization process was performed using the equation: "
            "```embeddings_norm = embeddings / np.linalg.norm(embeddings, "
            "axis=1, keepdims=True)```.\n"
            "The normalized embeddings were used for linear probing analysis.\n\n"
        )

    data_folder = os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"]
    if args.model_name == "plip" and args.backbone == "default":
        args.backbone = os.environ.get("PC_DEFAULT_BACKBONE", "default")

    if args.dataset == "OpenPath":
        # OpenPath: the Twitter, reply and PathLAION CSVs under the data root
        parts = []
        for fname, source in [
            ("T-noQ.csv", "Twitter"),
            ("R-noQ.csv", "Twitter reply"),
            ("L.csv", "PathLAION"),
        ]:
            p = opj(data_folder, fname)
            if not os.path.exists(p):
                continue
            d = pd.read_csv(p)
            d["source"] = source
            d["hashtag"] = (
                [os.path.basename(os.path.dirname(v)) for v in d["image"]]
                if source != "PathLAION"
                else "----"
            )
            d["media ID"] = [os.path.basename(v).split(".")[0] for v in d["image"]]
            parts.append(d)
        if not parts:
            raise FileNotFoundError(
                f"No OpenPath CSVs (T-noQ/R-noQ/L.csv) under {data_folder}"
            )
        df = pd.concat(parts, axis=0)
        cols = [c for c in ["source", "hashtag", "weblink", "id", "media ID", "caption"]
                if c in df.columns]
        df_public = df[cols].reset_index(drop=True)
        df_public.to_csv(opj(savepath, f"df_{len(df_public)}.csv"))
    else:
        df = pd.read_csv(opj(data_folder, f"{args.dataset}.csv"), index_col=0)
        if "text_style_4" in df.columns:
            df = df.rename(columns={"text_style_4": "caption"})
        if args.dataset.startswith("Kather"):
            df["filename"] = [os.path.basename(v) for v in df["image"]]
            df_public = df[["filename", "label", "caption"]].reset_index(drop=True)
        elif args.dataset.startswith("PanNuke") and "text_style_0" in df.columns:
            df_public = df[["text_style_0", "label", "label_text", "caption"]].reset_index(
                drop=True)
            df_public = df_public.rename(columns={"text_style_0": "tissue"})
            df_public["tissue"] = [
                v.replace("benign ", "").replace("malignant ", "")
                for v in df_public["tissue"]
            ]
            df_public["label"] = df_public["label"].astype(int)
        else:
            keep = [c for c in ["label", "label_text", "caption"] if c in df.columns]
            df_public = df[keep].reset_index(drop=True)
        df_public.to_csv(opj(savepath, f"{args.dataset}.csv"))

    image_embeddings, text_embeddings = extract_embedding(args, args.dataset, df)
    image_norm = image_embeddings / np.linalg.norm(image_embeddings, axis=1, keepdims=True)
    text_norm = text_embeddings / np.linalg.norm(text_embeddings, axis=1, keepdims=True)

    np.save(opj(savepath, f"{args.dataset}_image_embeddings.npy"), image_embeddings)
    np.save(opj(savepath, f"{args.dataset}_text_embeddings.npy"), text_embeddings)
    np.save(opj(savepath, f"{args.dataset}_image_embeddings_normalized.npy"), image_norm)
    np.save(opj(savepath, f"{args.dataset}_embeddings_normalized.npy"), text_norm)
    return savepath


if __name__ == "__main__":
    main()
