"""plip_tpu_torch — the PyTorch and CUDA port of plip_tpu.

Runs the PLIP CLIP dual encoder on an NVIDIA GPU: the attention sublayer of
both towers goes through hand-written CUDA kernels (``ops/attention.py``,
``csrc/``), the rest is plain PyTorch. Module names follow ``plip_tpu``, which
stays the numerical reference; this package never imports JAX.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level conveniences (keep bare `import plip_tpu_torch` light)
    if name == "PLIP":
        from .api import PLIP

        return PLIP
    if name == "CLIPConfig":
        from .models.config import CLIPConfig

        return CLIPConfig
    raise AttributeError(f"module 'plip_tpu_torch' has no attribute {name!r}")
