"""Zero-shot evaluation CLI: the port of
``plip_tpu.scripts.zero_shot_evaluation``, with the reference harness's
flags, environment and files, plus ``--device``.

Usage::

    python -m plip_tpu_torch.scripts.zero_shot_evaluation --dataset kather
        [--model_name plip] [--backbone default] [--caption_column text_style_4]
        [--device cpu]

Reads ``$PC_EVALUATION_DATA_ROOT_FOLDER/{dataset}_test.csv``, embeds its
images (batch 512) and unique captions, and appends the metrics through
``ResultsHandler``. The model runs on ``--device`` (default: the CUDA
device). pandas is imported inside ``main``.
"""

import argparse
import logging
import os
import sys

import numpy as np

from ..embedders.factory import EmbedderFactory
from ..eval.zero_shot import ZeroShotClassifier
from ..utils.config import load_dotenv_file
from ..utils.results_handler import ResultsHandler

logging.basicConfig(stream=sys.stdout, level=logging.INFO)


def config(argv=None):
    load_dotenv_file(os.environ.get("PC_DOTENV", "../config.env"))
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="plip", type=str)
    parser.add_argument(
        "--caption_column", default="text_style_4", type=str,
        help="text_style_4 is the 'An H&E image of XXX.' prompt style; "
        "text_style_0 is the bare categorical label.",
    )
    parser.add_argument("--backbone", default="default", type=str)
    parser.add_argument("--dataset", default="kather", type=str)
    parser.add_argument("--batch-size", default=128, type=int)
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--alpha", default=0.01, type=float)
    parser.add_argument("--device", default=None, type=str,
                        help="where the model runs (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None):
    import pandas as pd

    args = config(argv)
    np.random.seed(args.seed)
    data_folder = os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"]
    if args.model_name == "plip" and args.backbone == "default":
        args.backbone = os.environ["PC_DEFAULT_BACKBONE"]

    test_dataset_name = args.dataset + "_test.csv"
    test_dataset = pd.read_csv(os.path.join(data_folder, test_dataset_name))
    embedder = EmbedderFactory().factory(args)

    test_x = embedder.image_embedder(
        test_dataset["image"].tolist(),
        additional_cache_name=test_dataset_name,
        batch_size=512,
        num_workers=args.num_workers,
    )
    labels = test_dataset["label"].unique().tolist()
    test_y = embedder.text_embedder(
        test_dataset[args.caption_column].unique().tolist(),
        additional_cache_name=test_dataset_name,
        batch_size=512,
    )

    prober = ZeroShotClassifier()
    results = prober.zero_shot_classification(
        test_x, test_y, unique_labels=labels,
        target_labels=test_dataset["label"].tolist(),
    )

    additional_parameters = {
        "dataset": args.dataset, "seed": args.seed,
        "model": args.model_name, "backbone": args.backbone,
    }
    rs = ResultsHandler(args.dataset, "zero_shot", additional_parameters)
    rs.add(list(results))
    return results


if __name__ == "__main__":
    main()
