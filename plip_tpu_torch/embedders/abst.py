"""Embedder interface (the reference harness's ``embedders/abst.py``): a copy
of ``plip_tpu.embedders.abst``."""

from abc import ABC, abstractmethod


class AbstractEmbedder(ABC):
    @abstractmethod
    def image_embedder(self, images, device=None, num_workers=1, batch_size=32):
        ...

    @abstractmethod
    def text_embedder(self, texts, device=None, num_workers=1, batch_size=32):
        ...
