"""Post-process chain: accumulate -> firefly clamp -> un-jitter -> bilateral
-> TAA -> ACES -> sharpen -> gamma.

The port of the JAX package's `ops/postprocess.py` (plain jnp there, with
no Pallas kernel), in plain PyTorch. `frame_count` is an int or a 0-d
int64 tensor on the image's device; the frame-dependent selections (the
un-jitter resample, the TAA clamp width and blend weight) are made on the
device, in the JAX package's order of f32 operations, so a captured
present step replays them with the count it reads there.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import frame_tensor
from .v3 import sqrt_rn


def _edge_pad(img):
    """Pad H, W by 1 with edge clamping."""
    H, W, _ = img.shape
    ys = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    xs = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    return img[ys][:, xs]


def _shift(padded, dy, dx, H, W):
    return padded[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W, :]


def get_radiance(acc):
    """(H,W,4) sum+count -> mean radiance; zero where no samples."""
    a = acc[..., 3:4]
    return torch.where(a > 0.0, acc[..., 0:3] / torch.clamp(a, min=1e-20),
                       0.0)


def firefly_clamp(rad):
    """Clamp each pixel to 3x the 3x3 neighborhood max + 0.1."""
    H, W, _ = rad.shape
    p = _edge_pad(rad)
    max_nb = torch.full_like(rad, -1e6)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            max_nb = torch.maximum(max_nb, _shift(p, dy, dx, H, W))
    return torch.minimum(torch.clamp(rad, min=0.0), max_nb * 3.0 + 0.1)


def _bilinear_sample(img, fy, fx):
    """Clamped bilinear gather at float pixel coords (fy, fx), both (H,W)."""
    H, W, _ = img.shape
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]

    def at(yi, xi):
        return img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

    c00 = at(y0, x0)
    c10 = at(y0, x0 + 1)
    c01 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    return ((c00 * (1 - wx) + c10 * wx) * (1 - wy)
            + (c01 * (1 - wx) + c11 * wx) * wy)


def unjittered_radiance(clean, frame_count, average_jitter):
    """Resample at uv - average_jitter for the first 16 frames (a select:
    every frame computes the resample, as the JAX package's does)."""
    H, W, _ = clean.shape
    dev = clean.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] \
        * torch.ones((1, W), dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] \
        * torch.ones((H, 1), dtype=torch.float32, device=dev)
    fy = ys + 0.5 - average_jitter[1] * H - 0.5
    fx = xs + 0.5 - average_jitter[0] * W - 0.5
    resampled = _bilinear_sample(clean, fy, fx)
    return torch.where(frame_tensor(frame_count, clean.device) > 16, clean,
                       resampled)


def aces(color):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((color * (a * color + b))
                       / (color * (c * color + d) + e), 0.0, 1.0)


def postprocess(acc, history, frame_count, average_jitter,
                unjitter: bool = True):
    """Full chain. acc (H,W,4), history (H,W,3) HDR, average_jitter (2,)
    f32 and frame_count (an int or a 0-d int64 tensor) on the same device.
    unjitter=False skips the un-jitter resample, which a frame past 16
    computes and does not select: the same image, for a caller that knows
    the frame count is past 16. Returns (ldr uint8 (H,W,3),
    new_history)."""
    frame_count = frame_tensor(frame_count, acc.device)
    rad = get_radiance(acc)
    clean = firefly_clamp(rad)
    u = (unjittered_radiance(clean, frame_count, average_jitter) if unjitter
         else clean)

    H, W, _ = u.shape
    up = _edge_pad(u)

    # Bilateral 3x3, sigma_s = 0.5, sigma_r = 0.1.
    SIGMA_S = 0.5
    SIGMA_R = 0.1
    filtered = torch.zeros_like(u)
    weight = torch.zeros((H, W, 1), dtype=u.dtype, device=u.device)
    m1 = torch.zeros_like(u)
    m2 = torch.zeros_like(u)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = _shift(up, dy, dx, H, W)
            w_s = float(np.exp(np.float32(
                -(dx * dx + dy * dy) / (2.0 * SIGMA_S * SIGMA_S))))
            diff = nb - u
            w_r = torch.exp(-torch.sum(diff * diff, dim=-1, keepdim=True)
                            / (2.0 * SIGMA_R))
            w = w_s * w_r
            filtered = filtered + nb * w
            weight = weight + w
            m1 = m1 + nb
            m2 = m2 + nb * nb
    denoised = filtered / torch.clamp(weight, min=1e-4)

    # TAA with neighborhood mean +- k*sigma clamping.
    mean = m1 / 9.0
    std = sqrt_rn(torch.clamp(m2 / 9.0 - mean * mean, min=0.0))
    k = torch.where(frame_count > 16, 60.0, 1.0)
    clamped_hist = torch.minimum(torch.maximum(history, mean - std * k),
                                 mean + std * k)
    alpha = torch.clamp(torch.reciprocal(torch.clamp(
        frame_count.to(torch.float32), min=1.0)), min=1e-4)
    alpha = torch.where(frame_count == 1, 0.1, alpha)
    final_hdr = clamped_hist + (denoised - clamped_hist) * alpha

    # Tone map + sharpen + gamma.
    mapped = aces(final_hdr)
    sharpened = mapped + aces(u - denoised) * 0.3
    ldr = torch.clamp(sharpened, 0.0, 1.0) ** (1.0 / 2.2)
    ldr_u8 = (ldr * 255.0 + 0.5).to(torch.uint8)
    return ldr_u8, final_hdr
