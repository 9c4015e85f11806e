from .abst import AbstractEmbedder
from .clip_embedder import CLIPEmbedder
from .factory import EmbedderFactory
from .mudipath import DenseNetEmbedder, build_densenet, build_resnet

__all__ = ["AbstractEmbedder", "CLIPEmbedder", "DenseNetEmbedder", "EmbedderFactory",
           "build_densenet", "build_resnet"]
