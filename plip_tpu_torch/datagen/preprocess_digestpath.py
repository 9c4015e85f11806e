"""DigestPath WSI -> patch pipeline: the port's copy of
``plip_tpu.datagen.preprocess_digestpath`` (the reference harness's
``preprocess_DigestPath.py``).

For now only ``background_ratio``, the background rule that the streaming
WSI pipeline (``data/wsi.py``) filters tiles by; the offline harvest comes
with the rest of ``datagen/``.
"""

from __future__ import annotations

import numpy as np


def background_ratio(rgb: np.ndarray, threshold: int = 200) -> float:
    """Fraction of pixels with all channels >= threshold
    (preprocess_DigestPath.py:28-34)."""
    bg_mask = (
        (rgb[..., 0] >= threshold)
        & (rgb[..., 1] >= threshold)
        & (rgb[..., 2] >= threshold)
    )
    return float(np.sum(bg_mask)) / (rgb.shape[0] * rgb.shape[1])
