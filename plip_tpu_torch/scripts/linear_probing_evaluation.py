"""Linear probing CLI: the port of
``plip_tpu.scripts.linear_probing_evaluation``, with the reference harness's
flags, environment and files (the per-run
``{results}/{dataset}/{model}/seed=/alpha=/{backbone}.csv`` too), plus
``--device``.

Usage::

    python -m plip_tpu_torch.scripts.linear_probing_evaluation --dataset Kather
        [--alpha 0.01] [--probe_backend sklearn|torch] [--device cpu]

``--probe_backend sklearn`` (default) is the reference's ``SGDClassifier``;
``torch`` the PyTorch probe of ``eval.linear_probe``, on ``--device``
(default: the CUDA device), as the model is. ``model_name="mudipath"``
embeds with DenseNet-121 (``embedders.mudipath``). pandas is imported inside
``main``.
"""

import argparse
import logging
import os
import sys

import numpy as np

from ..embedders.factory import EmbedderFactory
from ..eval.linear_probe import LinearProber
from ..utils.config import load_dotenv_file
from ..utils.results_handler import ResultsHandler

logging.basicConfig(stream=sys.stdout, level=logging.INFO)


def config(argv=None):
    load_dotenv_file(os.environ.get("PC_DOTENV", "../config.env"))
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--model_name", default="plip", type=str, choices=["plip", "clip", "mudipath"]
    )
    parser.add_argument("--backbone", default="default", type=str)
    parser.add_argument("--dataset", default="Kather", type=str)
    parser.add_argument("--batch-size", default=128, type=int)
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--alpha", default=0.01, type=float)
    parser.add_argument("--probe_backend", default="sklearn", choices=["sklearn", "torch"])
    parser.add_argument("--device", default=None, type=str,
                        help="where the model and the torch probe run (default: the CUDA "
                        "device)")
    return parser.parse_args(argv)


def main(argv=None):
    import pandas as pd

    args = config(argv)
    np.random.seed(args.seed)
    data_folder = os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"]
    if args.model_name == "plip" and args.backbone == "default":
        args.backbone = os.environ["PC_DEFAULT_BACKBONE"]

    print("Now working on:")
    print(f"    Dataset: {args.dataset}")
    print(f"    Model: {args.model_name}")
    print(f"    Backbone: {args.backbone}")

    train_dataset_name = args.dataset + "_train.csv"
    test_dataset_name = args.dataset + "_test.csv"
    train_dataset = pd.read_csv(os.path.join(data_folder, train_dataset_name))
    test_dataset = pd.read_csv(os.path.join(data_folder, test_dataset_name))

    embedder = EmbedderFactory().factory(args)
    train_x = embedder.image_embedder(
        train_dataset["image"].tolist(),
        additional_cache_name=train_dataset_name,
        num_workers=args.num_workers,
    )
    test_x = embedder.image_embedder(
        test_dataset["image"].tolist(),
        additional_cache_name=test_dataset_name,
        num_workers=args.num_workers,
    )

    prober = LinearProber(alpha=args.alpha, seed=args.seed, backend=args.probe_backend,
                          device=args.device)
    classifier, results = prober.train_and_test(
        train_x=train_x, train_y=train_dataset["label"].tolist(),
        test_x=test_x, test_y=test_dataset["label"].tolist(),
    )

    additional_parameters = {
        "dataset": args.dataset, "seed": args.seed, "model": args.model_name,
        "backbone": args.backbone, "alpha": args.alpha,
    }
    rs = ResultsHandler(args.dataset, "linear_probing", additional_parameters)
    rs.add(list(results))

    # the per-run CSV layout (the reference's 'new codes' block)
    opj = os.path.join
    savedir = opj(
        os.environ["PC_RESULTS_FOLDER"], args.dataset, args.model_name,
        "seed=%d" % args.seed, "alpha=" + str(args.alpha),
    )
    os.makedirs(savedir, exist_ok=True)
    backbone = args.backbone
    if args.model_name == "plip":
        backbone = os.path.basename(backbone)
    save_filename = opj(savedir, "%s.csv" % backbone)
    test_perf, train_perf = results
    perf = pd.concat(
        [pd.DataFrame(train_perf, index=[0]), pd.DataFrame(test_perf, index=[1])],
        axis=0,
    )
    perf.to_csv(save_filename)
    return results


if __name__ == "__main__":
    main()
