"""Embedding disk cache: a copy of ``plip_tpu.utils.cacher``, with the same
on-disk layout as the reference harness's ``reproducibility/utils/cacher.py``,
so an entry written by either package (or the reference) is read by the
others:

- by hash: ``$PC_CACHE_FOLDER/<sha256(name + path)>`` (text embeddings);
- by name: ``$PC_CACHE_FOLDER/{dataset}/{model}/{backbone-basename}`` (image
  embeddings), with a ``<entry>.meta.json`` sidecar that records the
  ``decode_mode`` which produced it. An entry without one (the reference's)
  reads back as ``None``, "unknown".
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np


def _cache_folder() -> str:
    return os.environ["PC_CACHE_FOLDER"]


def get_cache_name(name: str, path: str) -> str:
    m = hashlib.sha256()
    m.update((name + path).encode("utf-8"))
    return os.path.join(_cache_folder(), m.hexdigest())


def cache_hit_or_miss(name: str, path: str) -> Optional[np.ndarray]:
    save_path = get_cache_name(name, path)
    if os.path.exists(save_path):
        return np.load(save_path)
    return None


def cache_numpy_object(npa: np.ndarray, name: str, path: str) -> None:
    save_path = get_cache_name(name, path)
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    with open(save_path, "wb") as f:
        np.save(f, npa)


def get_savepath(name: str, path: str) -> str:
    """``{cache}/{dataset}/{model}/{backbone-basename}``; ``name`` is
    ``{model}img{dataset}[.csv...]`` as the embedders compose it."""
    modelname, dataset_name = name.split("img", 1)
    dataset_name = dataset_name.split(".csv")[0]
    cache_subfolder = os.path.join(_cache_folder(), dataset_name, modelname)
    os.makedirs(cache_subfolder, exist_ok=True)
    if modelname == "plip":
        path = os.path.basename(path)
    else:
        # unlike the reference, an absolute backbone path never escapes the
        # cache folder (os.path.join would discard cache_subfolder)
        path = path.lstrip(os.sep)
    if not path:
        path = "embeddings.npy"
    return os.path.join(cache_subfolder, path)


def cache_hit_or_miss_raw_filename(name: str, path: str) -> Optional[np.ndarray]:
    save_path = get_savepath(name, path)
    if os.path.exists(save_path):
        return np.load(save_path)
    return None


def cache_numpy_object_raw_filename(npa: np.ndarray, name: str, path: str) -> None:
    save_path = get_savepath(name, path)
    with open(save_path, "wb") as f:
        np.save(f, npa)


def _meta_path(save_path: str) -> str:
    return save_path + ".meta.json"


def write_cache_meta(save_path: str, meta: dict) -> None:
    with open(_meta_path(save_path), "w") as f:
        json.dump(meta, f)


def read_cache_meta(save_path: str) -> Optional[dict]:
    p = _meta_path(save_path)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):  # an unreadable sidecar is "unknown"
        return None
