"""Image primitives: grayscale, separable Gaussian blur, gradients, sampling.
Plain PyTorch on [...,H,W] / [H,W,C] tensors (counterpart of the JAX
package's ops/image.py; the arithmetic follows that code, not its comments:
``gaussian_blur`` pads in edge mode and ``sobel_gradients`` wraps around)."""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[...,H,W,3] uint8/float → [...,H,W] float32 luma (BT.601 weights)."""
    img = img.to(torch.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d_edge(x: torch.Tensor, k: np.ndarray, radius: int,
                 axis: int) -> torch.Tensor:
    """'Same' correlation along ``axis`` with edge (replicate) padding, as a
    sum of shifted planes in the JAX code's order."""
    axis = axis % x.ndim
    n = x.shape[axis]
    src = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, src)
    out = torch.zeros_like(x)
    for i in range(len(k)):
        out = out + float(k[i]) * xp.narrow(axis, i, n)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur on [...,H,W] via two 1-D passes."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel(sigma, radius)
    return _conv1d_edge(_conv1d_edge(img, k, radius, -1), k, radius, -2)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (dx, dy) on [...,H,W], wrapping at the
    borders (jnp.roll semantics)."""
    dx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    dy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return dx, dy


def sample_maps(maps_hwc: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-sample a channel stack [H,W,C] at xy [...,2] → [...,C]."""
    H, W, _ = maps_hwc.shape
    xi = torch.clamp(torch.round(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).long(), 0, H - 1)
    return maps_hwc[yi, xi]


def sample_maps_bilinear(maps_hwc: torch.Tensor,
                         xy: torch.Tensor) -> torch.Tensor:
    """Bilinear variant of ``sample_maps``: [H,W,C] at xy [...,2] → [...,C]."""
    H, W, _ = maps_hwc.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    v00 = maps_hwc[y0, x0]
    v01 = maps_hwc[y0, x1]
    v10 = maps_hwc[y1, x0]
    v11 = maps_hwc[y1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def extract_patch_colors(img_rgb: torch.Tensor,
                         xy: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel RGB at keypoint coords (landmark colors)."""
    H, W = img_rgb.shape[:2]
    xi = torch.clamp(torch.round(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).long(), 0, H - 1)
    return img_rgb[yi, xi]
