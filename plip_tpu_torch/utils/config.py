"""Typed configuration with the reference harness's ``PC_*`` environment
variables (``config_example.env``): a copy of ``plip_tpu.utils.config``."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass
class PCConfig:
    cache_folder: str = "./cache"
    results_folder: str = "./results"
    evaluation_data_root_folder: str = "./data"
    clip_arch: str = "ViT-B/32"
    default_backbone: str = ""

    @staticmethod
    def from_env() -> "PCConfig":
        return PCConfig(
            cache_folder=os.environ.get("PC_CACHE_FOLDER", "./cache"),
            results_folder=os.environ.get("PC_RESULTS_FOLDER", "./results"),
            evaluation_data_root_folder=os.environ.get(
                "PC_EVALUATION_DATA_ROOT_FOLDER", "./data"
            ),
            clip_arch=os.environ.get("PC_CLIP_ARCH", "ViT-B/32"),
            default_backbone=os.environ.get("PC_DEFAULT_BACKBONE", ""),
        )

    def export_env(self) -> None:
        os.environ["PC_CACHE_FOLDER"] = self.cache_folder
        os.environ["PC_RESULTS_FOLDER"] = self.results_folder
        os.environ["PC_EVALUATION_DATA_ROOT_FOLDER"] = self.evaluation_data_root_folder
        os.environ["PC_CLIP_ARCH"] = self.clip_arch
        os.environ["PC_DEFAULT_BACKBONE"] = self.default_backbone


def load_dotenv_file(path: str) -> None:
    """Minimal .env loader (the reference uses python-dotenv).

    Lines of ``KEY=value``; the existing environment wins, as dotenv's
    default ``override=False`` does.
    """
    p = Path(path)
    if not p.exists():
        return
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        os.environ.setdefault(key.strip(), val.strip().strip('"').strip("'"))
