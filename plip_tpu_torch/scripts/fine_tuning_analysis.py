"""Fine-tuning results harvester/plotter: the port of
``plip_tpu.scripts.fine_tuning_analysis`` (the reference harness's
``scripts/fine_tuning_analysis.py``).

Collects ``performance_test_best_lr*.tsv`` across datasets x train_ratios x
seeds, prints per-dataset tables, aggregates mean±std, saves
``perf_mean.csv`` and ``performance.{png,pdf}`` line plots (plotting only
where matplotlib is installed). It runs no model, so it takes no
``--device``; pandas is imported inside its functions.

Usage::

    python -m plip_tpu_torch.scripts.fine_tuning_analysis
        --save_directory ./results/fine_tuning [--models plip vit_b_32]
"""

import argparse
import copy
import glob
import os

import numpy as np

opj = os.path.join

DATASETS = ["Kather_train", "PanNuke", "DigestPath", "WSSS4LUAD_binary"]
TRAIN_RATIOS = [0.01, 0.05, 0.1, 0.5, 1]


def config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--percentage_of_training_data", default=1.0, type=float)
    parser.add_argument("--valid_ratio", default=0.3, type=float)
    parser.add_argument("--batch-size", default=128, type=int)
    parser.add_argument("--weight-decay", default=0.1, type=float)
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--optimizer", default="AdamW", type=str)
    parser.add_argument("--save_directory", default="./results/fine_tuning")
    parser.add_argument("--models", nargs="*", default=["plip", "vit_b_32"])
    parser.add_argument("--num_seeds", default=10, type=int)
    return parser.parse_args(argv)


def harvest(args):
    import pandas as pd

    random_seeds = np.arange(args.num_seeds)
    multicol = pd.MultiIndex.from_product(
        [DATASETS, TRAIN_RATIOS, random_seeds],
        names=["dataset", "train_ratio", "random_seed"],
    )
    perf_df = pd.DataFrame(index=args.models, columns=multicol)

    for dataset in DATASETS:
        for model in args.models:
            for train_ratio in TRAIN_RATIOS:
                for random_seed in random_seeds:
                    if model == "plip":
                        savesubdir = (
                            f"PLIP_btch={args.batch_size}_wd={args.weight_decay}"
                            f"_nepochs={args.epochs}_validratio={args.valid_ratio}"
                            f"_optimizer={args.optimizer}"
                        )
                    else:
                        savesubdir = f"{model}"
                    parent = opj(
                        args.save_directory, dataset,
                        f"train_ratio={float(train_ratio)}", savesubdir,
                    )
                    if not os.path.exists(parent):
                        continue
                    candidates = [
                        opj(parent, v)
                        for v in os.listdir(parent)
                        if int(v.split("random_seed=")[1].split("_")[0]) == random_seed
                    ]
                    candidates = list(np.sort(candidates))
                    result_folder = None
                    for rs in candidates:
                        if glob.glob(opj(rs, "performance_test_*.tsv")):
                            result_folder = rs
                            break
                    if result_folder is None:
                        continue
                    tsvs = [
                        opj(result_folder, v)
                        for v in os.listdir(result_folder)
                        if v.startswith("performance_test_best_lr")
                    ]
                    if len(tsvs) != 1:
                        continue
                    tp = pd.read_csv(tsvs[0], sep="\t", index_col=0)
                    perf_df.loc[model, (dataset, train_ratio, random_seed)] = (
                        tp["f1_weighted"].values[-1]
                    )
    return perf_df


def aggregate(perf_df, models):
    import pandas as pd

    multicol = pd.MultiIndex.from_product(
        [DATASETS, TRAIN_RATIOS], names=["dataset", "train_ratio"]
    )
    perf_df_mean = pd.DataFrame(index=perf_df.index, columns=multicol)
    for model in perf_df.index:
        for dataset in DATASETS:
            for train_ratio in TRAIN_RATIOS:
                sel = perf_df.loc[
                    model,
                    (perf_df.columns.get_level_values("dataset") == dataset)
                    & (perf_df.columns.get_level_values("train_ratio") == train_ratio),
                ]
                vals = sel.values.astype(float)
                if np.isnan(vals).all():
                    continue
                perf_df_mean.loc[model, (dataset, train_ratio)] = (
                    f"{np.nanmean(vals):.3f}±{np.nanstd(vals):.3f}"
                )
    return perf_df_mean


def plot(perf_df, savedir):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    fig, axes = plt.subplots(1, len(DATASETS), figsize=(16, 4), sharey=False)
    for i, dataset in enumerate(DATASETS):
        ax = axes[i] if len(DATASETS) > 1 else axes
        sub = perf_df.loc[:, perf_df.columns.get_level_values("dataset") == dataset]
        for model in sub.index:
            means, ratios = [], []
            for tr in TRAIN_RATIOS:
                vals = sub.loc[
                    model, sub.columns.get_level_values("train_ratio") == tr
                ].values.astype(float)
                if np.isnan(vals).all():
                    continue
                ratios.append(tr)
                means.append(np.nanmean(vals))
            if means:
                ax.plot(ratios, means, marker="o", label=model)
        ax.set_xscale("log")
        ax.set_title(dataset)
        ax.set_xlabel("train ratio")
        ax.set_ylabel("weighted F1")
        ax.legend()
    fig.tight_layout()
    fig.savefig(opj(savedir, "performance.png"), dpi=150)
    fig.savefig(opj(savedir, "performance.pdf"))
    plt.close(fig)


def main(argv=None):
    args = config(argv)
    perf_df = harvest(args)

    print("---------------------------------------------------------")
    for dataset in DATASETS:
        temp = perf_df.loc[:, perf_df.columns.get_level_values("dataset") == dataset]
        print(f"Dataset: {dataset}")
        print(temp.astype(float).round(decimals=3).T)

    perf_df_mean = aggregate(perf_df, args.models)
    print("---------------------------------------------------------")
    print("Mean performance by averaging datasets")
    print(perf_df_mean)

    savedir = opj(args.save_directory, "__figures")
    os.makedirs(savedir, exist_ok=True)
    temp_df = copy.deepcopy(perf_df_mean)
    temp_df = temp_df.stack(level=1, future_stack=True)
    temp_df.reset_index(level=[0, 1], drop=False, inplace=True)
    temp_df.sort_values(by="train_ratio", inplace=True)
    temp_df.to_csv(opj(savedir, "perf_mean.csv"))
    plot(perf_df, savedir)
    return perf_df_mean


if __name__ == "__main__":
    main()
