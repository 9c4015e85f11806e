"""The image arithmetic the program runs on the card, worked out again:
evaluation preprocessing and training augmentation. Imports nothing of the
program.

- ``preprocess``: PIL's bicubic ``Resize(n)`` (Keys cubic, a = -0.5, the
  support widened by the downscale factor, windows renormalized at the
  borders), torchvision's ``CenterCrop(n)``, a uint8 store after each of
  PIL's two passes (width first, round half up), then CLIP's normalize. The
  two passes are dense matrices, worked out in float64 and applied in
  float32, the precision the configurations state for preprocessing.
- ``sample_warp`` / ``warp_normalize``: the training transform (RandomCrop,
  HFlip, RandomAffine, RandomPerspective, fill 127, normalize) as one
  homography an image and a bilinear warp, the draws taken from a
  ``torch.Generator`` in a fixed order, so the same seed gives the same maps.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                    np.where(x < 2, a * (x ** 3 - 5 * x ** 2 + 8 * x - 4), 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` float64: PIL's bicubic resampling of one axis."""
    scale = n_in / n_out
    support = 2.0 * max(scale, 1.0)
    mat = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo, hi = max(int(center - support + 0.5), 0), min(int(center + support + 0.5), n_in)
        w = _cubic((np.arange(lo, hi) - center + 0.5) / max(scale, 1.0))
        mat[i, lo:hi] = w / w.sum() if w.sum() != 0 else w
    return mat


def crop_matrices(h: int, w: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows ``[n, h]``, columns ``[n, w]``): ``Resize(n)`` of the shorter
    side, then ``CenterCrop(n)``."""
    if h <= w:
        rh, rw = n, (w if h == n else int(n * w / h))
    else:
        rh, rw = (h if w == n else int(n * h / w)), n
    top, left = int(round((rh - n) / 2.0)), int(round((rw - n) / 2.0))
    return resize_matrix(h, rh)[top:top + n], resize_matrix(w, rw)[left:left + n]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device) * 255
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device) * 255
    return (x - mean) / std


def preprocess(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float32 ``[B, n, n, 3]``, CLIP-normalized."""
    R, C = (torch.as_tensor(m, dtype=torch.float32, device=tiles.device)
            for m in crop_matrices(tiles.shape[1], tiles.shape[2], n))
    x = tiles.float()
    x = torch.clamp(torch.floor(torch.einsum("jx,byxc->byjc", C, x) + 0.5), 0, 255)
    x = torch.clamp(torch.floor(torch.einsum("iy,byjc->bijc", R, x) + 0.5), 0, 255)
    return _normalize(x)


def _translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack([torch.stack([one, zero, tx], -1), torch.stack([zero, one, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def sample_warp(gen: torch.Generator, batch: int, in_size: int, aug: Mapping):
    """Per-image (M ``[B, 3, 3]`` output pixel -> crop coordinates, crop
    offsets ``[B, 2]`` (top, left), flip ``[B]``), drawn from ``gen`` in the
    transform's order: crop, flip, angle, translation, scale, two shears, the
    perspective's corners, whether it applies."""
    out = aug["out_size"]

    def rand(shape):
        return torch.rand(shape, generator=gen)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * rand(shape)

    offsets = torch.randint(0, in_size - out + 1, (batch, 2), generator=gen)
    flip = rand(batch) < aug["hflip_prob"]
    # degrees to radians as torchvision writes it: (x * pi) / 180
    angle = uniform(batch, -aug["degrees"], aug["degrees"]) * math.pi / 180.0
    tmax = torch.tensor(aug["translate"]) * out
    shift = uniform((batch, 2), -tmax, tmax)
    scale = uniform(batch, *aug["scale_range"])
    sx = uniform(batch, -aug["shear"][0], aug["shear"][0]) * math.pi / 180.0
    sy = uniform(batch, -aug["shear"][1], aug["shear"][1]) * math.pi / 180.0
    # torchvision's RandomAffine: T(shift) C R(angle) S(scale) Shear C^-1
    ca, sa, tx, ty = torch.cos(angle), torch.sin(angle), torch.tan(sx), torch.tan(sy)
    a, b = ca - sa * ty, ca * tx - sa * (1 + tx * ty)
    c, d = sa + ca * ty, sa * tx + ca * (1 + tx * ty)
    zero, one = torch.zeros_like(angle), torch.ones_like(angle)
    rss = torch.stack([torch.stack([scale * a, scale * b, zero], -1),
                       torch.stack([scale * c, scale * d, zero], -1),
                       torch.stack([zero, zero, one], -1)], -2)
    cen = (out - 1) / 2.0
    fwd = (_translation(shift[:, 0], shift[:, 1])
           @ _translation(torch.full_like(angle, cen), torch.full_like(angle, cen)) @ rss
           @ _translation(torch.full_like(angle, -cen), torch.full_like(angle, -cen)))
    # torchvision's RandomPerspective: corners moved inward, the homography
    # from the moved (output) corners to the original ones
    half = out / 2.0
    disp = rand((batch, 4, 2)) * aug["perspective_scale"] * half
    corners = torch.tensor([[0.0, 0.0], [out - 1.0, 0.0], [out - 1.0, out - 1.0],
                            [0.0, out - 1.0]])
    signs = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]])
    end = corners + signs * disp
    ex, ey = end[..., 0], end[..., 1]
    cx, cy = corners[:, 0].expand_as(ex), corners[:, 1].expand_as(ey)
    o, z = torch.ones_like(ex), torch.zeros_like(ex)
    A = torch.stack([torch.stack([ex, ey, o, z, z, z, -cx * ex, -cx * ey], -1),
                     torch.stack([z, z, z, ex, ey, o, -cy * ex, -cy * ey], -1)],
                    2).reshape(batch, 8, 8)
    h = torch.linalg.solve(A, corners.reshape(-1).expand(batch, 8))
    H = torch.cat([h, torch.ones(batch, 1)], 1).reshape(batch, 3, 3)
    H = torch.where((rand(batch) < aug["perspective_prob"])[:, None, None], H, torch.eye(3))
    return torch.linalg.inv(fwd) @ H, offsets, flip


def warp_normalize(tiles: torch.Tensor, M: torch.Tensor, offsets: torch.Tensor,
                   flip: torch.Tensor, aug: Mapping) -> torch.Tensor:
    """uint8 ``[B, S, S, 3]`` -> float32 ``[B, out, out, 3]``: each output
    pixel mapped by M into the crop (mirrored where flipped), sampled
    bilinearly, ``fill`` where it leaves the crop, CLIP-normalized."""
    B, S, _, C = tiles.shape
    out, dev = aug["out_size"], tiles.device
    M, offsets, flip = M.to(dev, torch.float32), offsets.to(dev), flip.to(dev)
    ii, jj = torch.meshgrid(torch.arange(out, device=dev, dtype=torch.float32),
                            torch.arange(out, device=dev, dtype=torch.float32), indexing="ij")
    gx, gy = jj.reshape(-1), ii.reshape(-1)
    w = M[:, 2, 0:1] * gx + M[:, 2, 1:2] * gy + M[:, 2, 2:3]
    u = (M[:, 0, 0:1] * gx + M[:, 0, 1:2] * gy + M[:, 0, 2:3]) / w
    v = (M[:, 1, 0:1] * gx + M[:, 1, 1:2] * gy + M[:, 1, 2:3]) / w
    inside = (u >= -0.5) & (u <= out - 0.5) & (v >= -0.5) & (v <= out - 0.5)
    u = torch.where(flip[:, None], (out - 1.0) - u, u)
    u = (u + offsets[:, 1:2].float()).clamp(0.0, S - 1.0)
    v = (v + offsets[:, 0:1].float()).clamp(0.0, S - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    u0, v0 = u0.long(), v0.long()
    u1, v1 = (u0 + 1).clamp(max=S - 1), (v0 + 1).clamp(max=S - 1)
    x = tiles.float()
    b = torch.arange(B, device=dev)[:, None]
    top = x[b, v0, u0] * (1 - du) + x[b, v0, u1] * du
    bot = x[b, v1, u0] * (1 - du) + x[b, v1, u1] * du
    val = torch.where(inside[..., None], top * (1 - dv) + bot * dv,
                      torch.tensor(aug["fill"], device=dev))
    return _normalize(val).reshape(B, out, out, C)
