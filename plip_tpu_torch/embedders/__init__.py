from .abst import AbstractEmbedder
from .clip_embedder import CLIPEmbedder
from .factory import EmbedderFactory

__all__ = ["AbstractEmbedder", "CLIPEmbedder", "EmbedderFactory"]
