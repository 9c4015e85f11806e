"""Batched training augmentation on the device: the port of
``plip_tpu.ops.augment``.

The reference's train transform (RandomCrop(224) -> HFlip -> RandomAffine
(+-10 deg, translate .1, scale .8-1.2, shear +-15, fill 127) ->
RandomPerspective(.3, p=.3, fill 127) -> normalize) is a chain of projective
maps, so it is one 3x3 homography per image and one batched bilinear warp
with the normalize folded in. ``sample_warp`` draws the per-image maps from
an explicit ``torch.Generator``; ``warp_normalize`` applies them on the
images' device.

The draws are not ``jax.random``'s, so an image gets another warp than in
the JAX package from the same seed; given the same ``(M, offsets, flip)``,
``warp_normalize`` computes the JAX package's function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    out_size: int = 224
    hflip_prob: float = 0.5
    degrees: float = 10.0
    translate: Tuple[float, float] = (0.1, 0.1)
    scale_range: Tuple[float, float] = (0.8, 1.2)
    shear: Tuple[float, float] = (15.0, 15.0)  # (+-x deg, +-y deg)
    perspective_scale: float = 0.3
    perspective_prob: float = 0.3
    fill: float = 127.0
    mean: Tuple[float, float, float] = CLIP_IMAGE_MEAN
    std: Tuple[float, float, float] = CLIP_IMAGE_STD


def _translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack([torch.stack([one, zero, tx], -1),
                        torch.stack([zero, one, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _affine_forward_matrix(angle, translate, scale, shear_x, shear_y, center):
    """Forward affine map T(translate) . C . R(angle) S(scale) Shear . C^-1,
    torchvision's RandomAffine composition (angles in radians): [B, 3, 3]."""
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    tan_sx, tan_sy = torch.tan(shear_x), torch.tan(shear_y)
    a = cos_a - sin_a * tan_sy
    b = cos_a * tan_sx - sin_a * (1 + tan_sx * tan_sy)
    c = sin_a + cos_a * tan_sy
    d = sin_a * tan_sx + cos_a * (1 + tan_sx * tan_sy)
    zero, one = torch.zeros_like(angle), torch.ones_like(angle)
    rss = torch.stack([torch.stack([scale * a, scale * b, zero], -1),
                       torch.stack([scale * c, scale * d, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    cx, cy = center
    c_plus = _translation(torch.full_like(angle, cx), torch.full_like(angle, cy))
    c_minus = _translation(torch.full_like(angle, -cx), torch.full_like(angle, -cy))
    return _translation(translate[:, 0], translate[:, 1]) @ c_plus @ rss @ c_minus


def _uniform(gen: torch.Generator, shape, lo, hi) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _perspective_matrix(gen: torch.Generator, batch: int, size: int, distortion: float,
                        prob: float) -> torch.Tensor:
    """torchvision RandomPerspective: each corner moves inward by
    U[0, distortion * half]; the homography maps the distorted (output)
    corners to the original ones (the direction sampling needs)."""
    half = size / 2.0
    dev = gen.device
    disp = torch.rand((batch, 4, 2), generator=gen, device=dev) * distortion * half
    corners = torch.tensor([[0.0, 0.0], [size - 1.0, 0.0], [size - 1.0, size - 1.0],
                            [0.0, size - 1.0]], device=dev)
    signs = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=dev)
    end = corners + signs * disp  # [B, 4, 2]
    ex, ey = end[..., 0], end[..., 1]  # [B, 4]
    sx, sy = corners[:, 0].expand_as(ex), corners[:, 1].expand_as(ey)
    one, zero = torch.ones_like(ex), torch.zeros_like(ex)
    rows_x = torch.stack([ex, ey, one, zero, zero, zero, -sx * ex, -sx * ey], -1)
    rows_y = torch.stack([zero, zero, zero, ex, ey, one, -sy * ex, -sy * ey], -1)
    A = torch.stack([rows_x, rows_y], 2).reshape(batch, 8, 8)  # rows x0, y0, x1, ...
    h = torch.linalg.solve(A, corners.reshape(-1).expand(batch, 8))
    H = torch.cat([h, torch.ones(batch, 1, device=dev)], 1).reshape(batch, 3, 3)
    apply = torch.rand(batch, generator=gen, device=dev) < prob
    return torch.where(apply[:, None, None], H, torch.eye(3, device=dev))


def sample_warp(gen: torch.Generator, batch: int, in_size: int, cfg: AugmentConfig,
                device=None):
    """Per-image maps, drawn on ``gen``'s device and returned on ``device``:
    (M [B, 3, 3] output px -> crop coords, offsets [B, 2] (top, left) of the
    crop in the in_size image, flip [B] bools)."""
    out = cfg.out_size
    dev = gen.device
    offsets = torch.randint(0, in_size - out + 1, (batch, 2), generator=gen, device=dev)
    flip = torch.rand(batch, generator=gen, device=dev) < cfg.hflip_prob
    angle = _uniform(gen, batch, -cfg.degrees, cfg.degrees) * math.pi / 180.0
    tmax = torch.tensor(cfg.translate, device=dev) * out
    translate = _uniform(gen, (batch, 2), -tmax, tmax)
    scale = _uniform(gen, batch, *cfg.scale_range)
    shear_x = _uniform(gen, batch, -cfg.shear[0], cfg.shear[0]) * math.pi / 180.0
    shear_y = _uniform(gen, batch, -cfg.shear[1], cfg.shear[1]) * math.pi / 180.0
    center = ((out - 1) / 2.0, (out - 1) / 2.0)
    fwd = _affine_forward_matrix(angle, translate, scale, shear_x, shear_y, center)
    persp = _perspective_matrix(gen, batch, out, cfg.perspective_scale,
                                cfg.perspective_prob)
    # output px --(perspective)--> affine output --(inverse affine)--> crop
    M = torch.linalg.inv(fwd) @ persp
    return M.to(device), offsets.to(device), flip.to(device)


def warp_normalize(images: torch.Tensor, M: torch.Tensor, offsets: torch.Tensor,
                   flip: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """``images [B, S, S, 3]`` (uint8 or float) -> ``[B, out, out, 3]`` fp32,
    warped by ``M`` into the crop at ``offsets`` (flipped where ``flip``),
    filled with ``cfg.fill`` outside the crop, CLIP-normalized."""
    B, S, _, C = images.shape
    out = cfg.out_size
    dev = images.device
    x = images.float()
    M = M.to(dev, torch.float32)
    ii, jj = torch.meshgrid(torch.arange(out, device=dev, dtype=torch.float32),
                            torch.arange(out, device=dev, dtype=torch.float32),
                            indexing="ij")
    gx, gy = jj.reshape(-1), ii.reshape(-1)  # [P]

    def row(r):  # M[:, r] . (x, y, 1), elementwise (no TF32 product)
        return M[:, r, 0:1] * gx + M[:, r, 1:2] * gy + M[:, r, 2:3]

    w = row(2)
    u = row(0) / w  # crop-space x
    v = row(1) / w  # crop-space y
    # torchvision fills where the warp leaves the crop
    inside = (u >= -0.5) & (u <= out - 0.5) & (v >= -0.5) & (v <= out - 0.5)
    u = torch.where(flip[:, None], (out - 1.0) - u, u)
    u = (u + offsets[:, 1:2].float()).clamp(0.0, S - 1.0)
    v = (v + offsets[:, 0:1].float()).clamp(0.0, S - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    u0, v0 = u0.long(), v0.long()
    u1, v1 = (u0 + 1).clamp(max=S - 1), (v0 + 1).clamp(max=S - 1)
    bidx = torch.arange(B, device=dev)[:, None]

    def gather(yy, xx):
        return x[bidx, yy, xx]  # [B, P, C]

    top = gather(v0, u0) * (1 - du) + gather(v0, u1) * du
    bot = gather(v1, u0) * (1 - du) + gather(v1, u1) * du
    val = top * (1 - dv) + bot * dv
    val = torch.where(inside[..., None], val, torch.tensor(cfg.fill, device=dev))
    mean = torch.tensor(cfg.mean, device=dev) * 255.0
    std = torch.tensor(cfg.std, device=dev) * 255.0
    return ((val - mean) / std).reshape(B, out, out, C)


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """``[B, S, S, 3]`` uint8 -> ``[B, out, out, 3]`` fp32, augmented and
    normalized on the images' device."""
    with span("augment.draw"):
        M, offsets, flip = sample_warp(gen, images.shape[0], images.shape[1], cfg,
                                       images.device)
    with span("augment.warp"):
        return warp_normalize(images, M, offsets, flip, cfg)
