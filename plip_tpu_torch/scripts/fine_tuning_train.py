"""Supervised fine-tuning with a learning-rate search: the port of
``plip_tpu.scripts.fine_tuning_train`` (the reference harness's
``scripts/fine_tuning_train.py``), plus ``--device``.

Label digitization (Kather ADI..TUM -> 0..8), few-shot subsampling,
train/valid split, LR grid search [1e-6..1e-2], best-weighted-F1-at-final-
epoch selection, retrain on train+valid, skip-if-done guard, per-run
arguments.csv + file log, ``performance_val.tsv`` /
``performance_test_best_lr=*.tsv`` outputs.

Usage::

    python -m plip_tpu_torch.scripts.fine_tuning_train --dataset Kather_train
        --model_name plip|clip|resnet18|resnet50|resnet101|vit_b_16|vit_b_32
        [--device cpu]

``FineTuner`` trains on ``--device`` (default: the CUDA device). pandas and
scikit-learn's ``train_test_split`` are imported inside ``main``.
"""

import argparse
import glob
import logging
import os
import time

import numpy as np

from ..utils.config import load_dotenv_file

opj = os.path.join


def convert_dataset_labels(args, df):
    """fine_tuning_train.py:24-35 (minus the hardcoded path rewrite)."""
    df = df[["image", "label"]].copy()
    if args.dataset.startswith("Kather"):
        label2digit = {
            "ADI": 0, "BACK": 1, "DEB": 2, "LYM": 3, "MUC": 4,
            "MUS": 5, "NORM": 6, "STR": 7, "TUM": 8,
        }
        df["label"] = df["label"].apply(lambda v: label2digit[v])
    elif args.dataset in ["DigestPath", "PanNuke", "WSSS4LUAD_binary"]:
        df["label"] = df["label"].astype(int)
    else:
        raise Exception("No dataset available.")
    return df


def tune_model(args, train, valid, test=None, logging=None):
    from ..train.finetune import FineTuner

    if args.model_name == "plip":
        backbone = args.backbone
    else:
        backbone = None
    cpt = FineTuner(
        args=args,
        logging=logging,
        backbone=backbone,
        num_classes=args.num_classes,
        lr=args.learning_rate,
        weight_decay=args.weight_decay,
        seed=args.random_seed,
        device=args.device,
    )
    return cpt.tuner(
        train, valid, test,
        save_directory=args.save_directory,
        batch_size=args.batch_size,
        epochs=args.epochs,
        evaluation_steps=args.evaluation_steps,
        num_workers=args.num_workers,
    )


def config(argv=None):
    load_dotenv_file(os.environ.get("PC_DOTENV", "../config.env"))
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="plip", type=str,
                        help="choose from: plip, clip, resnet18/50/101, vit_b_16/32")
    parser.add_argument("--backbone", default="default", type=str)
    parser.add_argument(
        "--dataset", default="Kather_train", type=str,
        choices=["Kather_train", "PanNuke", "WSSS4LUAD_binary", "DigestPath"],
    )
    parser.add_argument("--batch-size", default=128, type=int)
    parser.add_argument("--num_workers", default=8, type=int)
    parser.add_argument("--percentage_of_training_data", default=1.0, type=float)
    parser.add_argument("--valid_ratio", default=0.3, type=float)
    parser.add_argument("--weight-decay", default=0.1, type=float)
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--optimizer", default="AdamW", type=str)
    parser.add_argument("--evaluation-steps", default=0, type=int)
    parser.add_argument("--save_directory", default="./results/fine_tuning")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument(
        "--lr_search", nargs="*", type=float,
        default=[1e-6, 1e-5, 1e-4, 1e-3, 1e-2],  # fine_tuning_train.py:204
    )
    parser.add_argument("--device", default=None, type=str,
                        help="where FineTuner trains (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None):
    import pandas as pd
    from sklearn.model_selection import train_test_split

    args = config(argv)
    np.random.seed(args.random_seed)
    data_folder = os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"]
    args.PC_CLIP_ARCH = os.environ.get("PC_CLIP_ARCH", "ViT-B/32")
    if args.model_name == "plip" and args.backbone == "default":
        args.backbone = os.environ["PC_DEFAULT_BACKBONE"]

    print("Now working on:")
    print(f"    Dataset: {args.dataset}")
    print(f"    Model: {args.model_name}")
    print(f"    Backbone: {args.backbone}")

    # Step 1: dataset (Kather_train splits 10% off as test)
    if args.dataset == "Kather_train":
        train_dataset = pd.read_csv(opj(data_folder, "Kather_train.csv"))
        train_dataset, test_dataset = train_test_split(
            train_dataset, test_size=0.1, random_state=args.random_seed, shuffle=True
        )
    else:
        train_dataset = pd.read_csv(opj(data_folder, args.dataset + "_train.csv"))
        test_dataset = pd.read_csv(opj(data_folder, args.dataset + "_test.csv"))

    train_dataset = convert_dataset_labels(args, train_dataset)
    test_dataset = convert_dataset_labels(args, test_dataset)
    args.num_classes = len(train_dataset["label"].unique())

    # Step 2: subsample (few-shot) + shuffle
    print("Subsample dataset (few-shot)")
    print(f"Number of training data before sub-sampling: {len(train_dataset)}")
    train_dataset = train_dataset.sample(
        frac=args.percentage_of_training_data, random_state=args.random_seed
    )
    print(f"Number of training data after sub-sampling : {len(train_dataset)}")

    # Step 3: train/valid split + save dir + skip-if-done guard
    train, valid = train_test_split(
        train_dataset, test_size=args.valid_ratio,
        random_state=args.random_seed, shuffle=True,
    )
    print(
        f"Number of training: {len(train)} / validation: {len(valid)} / "
        f"testing: {len(test_dataset)}"
    )

    TIMESTRING = time.strftime("%Y%m%d-%H.%M.%S", time.localtime())
    if args.model_name == "plip":
        savesubdir = (
            f"PLIP_btch={args.batch_size}_wd={args.weight_decay}_nepochs={args.epochs}_"
            f"validratio={args.valid_ratio}_optimizer={args.optimizer}"
        )
    else:
        savesubdir = f"{args.model_name}"
    base_dir = args.save_directory
    args.save_directory = opj(
        base_dir, args.dataset, f"train_ratio={args.percentage_of_training_data}",
        savesubdir, f"random_seed={args.random_seed}_{TIMESTRING}",
    )
    os.makedirs(args.save_directory, exist_ok=True)

    matching_pattern = opj(
        base_dir, args.dataset, f"train_ratio={args.percentage_of_training_data}",
        savesubdir, f"random_seed={args.random_seed}_*", "performance_test_*.tsv",
    )
    if glob.glob(matching_pattern):
        print("A result with same seed already existed. Exit.")
        return None

    args_dump = {k: (str(v) if isinstance(v, (list, tuple)) else v)
                 for k, v in vars(args).items()}
    args_df = pd.DataFrame(args_dump, index=["Value"]).T
    args_df.to_csv(opj(args.save_directory, "arguments.csv"))
    print("------------------------------")
    print(args_df)
    print("------------------------------")

    log = logging.getLogger("fine_tuning_train")
    handler = logging.FileHandler(opj(args.save_directory, "_training.log"))
    handler.setFormatter(
        logging.Formatter("%(asctime)s.%(msecs)03d *** %(message)s", "%Y-%m-%d %H:%M:%S")
    )
    log.addHandler(handler)
    log.setLevel(logging.INFO)

    # Step 4: LR grid search
    lr_search_list = list(args.lr_search)
    print("==================================")
    print("Learning rate will be searched on:")
    print(lr_search_list)
    print("==================================")

    all_performance = pd.DataFrame()
    for lr in lr_search_list:
        print(f"Current learning rate: {lr}")
        log.info(f"Current learning rate: {lr}")
        args.learning_rate = lr
        performance = tune_model(args, train, valid, test_dataset, logging=log)
        performance["learning_rate"] = args.learning_rate
        all_performance = pd.concat(
            [all_performance, performance], axis=0
        ).reset_index(drop=True)
        all_performance.to_csv(opj(args.save_directory, "performance_val.tsv"), sep="\t")

    # best weighted-F1 at final epoch (fine_tuning_train.py:223-226)
    perf_maxepoch = all_performance.loc[all_performance["epoch"] == (args.epochs - 1)]
    best_lr = perf_maxepoch["learning_rate"][perf_maxepoch["f1_weighted"].idxmax()]
    print(f"Best learning rate: {best_lr}")
    log.info(f"Best learning rate: {best_lr}")

    # Step 5: retrain on train+valid with best lr
    args.learning_rate = best_lr
    train_dataset = train_dataset.sample(frac=1, random_state=args.random_seed)
    performance_test = tune_model(args, train_dataset, test_dataset, logging=log)
    performance_test["learning_rate"] = args.learning_rate
    out = opj(args.save_directory, f"performance_test_best_lr={args.learning_rate}.tsv")
    performance_test.to_csv(out, sep="\t")
    print(performance_test)
    return performance_test


if __name__ == "__main__":
    main()
