"""Text -> image retrieval CLI: the port of
``plip_tpu.scripts.retrieval_evaluation``, with the reference harness's
flags, environment and files, plus ``--device``.

Usage::

    python -m plip_tpu_torch.scripts.retrieval_evaluation --dataset NAME
        [--caption_column captions] [--device cpu]

Reads ``{dataset}_retrieval.tsv`` (tab-separated, columns ``images`` and
the captions) and appends p@10 and p@50 through ``ResultsHandler``. The
model runs on ``--device`` (default: the CUDA device). pandas is imported
inside ``main``.
"""

import argparse
import logging
import os
import sys

from ..embedders.factory import EmbedderFactory
from ..eval.retrieval import ImageRetrieval
from ..utils.config import load_dotenv_file
from ..utils.results_handler import ResultsHandler

logging.basicConfig(stream=sys.stdout, level=logging.INFO)


def config(argv=None):
    load_dotenv_file(os.environ.get("PC_DOTENV", "../config.env"))
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="plip", type=str)
    parser.add_argument("--caption_column", default="captions", type=str)
    parser.add_argument("--backbone", default="default", type=str)
    parser.add_argument("--dataset", type=str)
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="where the model runs (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None):
    import pandas as pd

    args = config(argv)
    data_folder = os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"]
    if args.model_name == "plip" and args.backbone == "default":
        args.backbone = os.environ["PC_DEFAULT_BACKBONE"]

    test_dataset_name = args.dataset + "_retrieval.tsv"
    test_dataset = pd.read_csv(os.path.join(data_folder, test_dataset_name), sep="\t")

    embedder = EmbedderFactory().factory(args)
    image_embeddings = embedder.image_embedder(
        test_dataset["images"].tolist(),
        additional_cache_name=test_dataset_name,
        num_workers=args.num_workers,
    )
    text_embeddings = embedder.text_embedder(
        test_dataset[args.caption_column].tolist(),
        additional_cache_name=test_dataset_name,
    )

    prober = ImageRetrieval()
    results = prober.retrieval(image_embeddings, text_embeddings)

    additional_parameters = {
        "dataset": args.dataset, "seed": args.seed,
        "model": args.model_name, "backbone": args.backbone,
    }
    rs = ResultsHandler(args.dataset, "retrieval", additional_parameters)
    rs.add(list(results))
    return results


if __name__ == "__main__":
    main()
