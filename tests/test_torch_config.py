"""The PyTorch port's model configs match the JAX package's field for field."""

import dataclasses

import pytest

from plip_tpu.models import config as jconfig
from plip_tpu.utils import checkpoint as jckpt
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.utils import checkpoint as tckpt


def _derived(cfg):
    v, t = cfg.vision, cfg.text
    return (v.head_dim, v.grid, v.seq_len, t.head_dim, t.eot)


def test_same_architectures():
    assert list(tconfig.ARCHITECTURES) == list(jconfig.ARCHITECTURES)


@pytest.mark.parametrize("arch", list(jconfig.ARCHITECTURES) + ["tiny"])
def test_config_matches_jax(arch):
    if arch == "tiny":
        j, t = jconfig.CLIPConfig.tiny(), tconfig.CLIPConfig.tiny()
    else:
        j, t = jconfig.ARCHITECTURES[arch](), tconfig.ARCHITECTURES[arch]()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert _derived(t) == _derived(j)
    # the checkpoint header is the same bytes in both packages
    assert tckpt.cfg_to_json(t) == jckpt.cfg_to_json(j)
    assert tckpt.cfg_from_json(jckpt.cfg_to_json(j)) == t


def test_normalization_constants():
    assert tconfig.CLIP_IMAGE_MEAN == jconfig.CLIP_IMAGE_MEAN
    assert tconfig.CLIP_IMAGE_STD == jconfig.CLIP_IMAGE_STD
