"""The present step's post-process chain: `csrc/present.cu` on the card,
the plain chain (`ops/postprocess.py`) on the CPU.

The kernels compute what `postprocess` computes (mean radiance, firefly
clamp, the un-jitter resample on the `unjitter=True` graph, the 3x3
bilateral, TAA, two ACES, sharpen, gamma, the 8-bit image) in the plain
chain's order of f32 operations, in two launches, and write the new TAA
history over `history`. The frame count and the average jitter are read
on the device, so a captured present replays with its frame's values. The
source says what bounds the kernels on the card.

The wrapper checks every tensor (dtype, shape, layout, device) before
it dispatches, on both devices. It takes the plain chain only for tensors
on the CPU; for CUDA tensors it launches the kernels or raises: there is
no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .postprocess import postprocess
from .rng import frame_tensor

# The plain chain's constants, as it rounds them to f32: the bilateral's
# spatial weights exp(-(dx^2 + dy^2) / (2 sigma_s^2)) by dx^2 + dy^2 = 0,
# 1, 2 (numpy's f32 exp), and ATen's reciprocals of the scalars the chain
# divides by (a tensor over a Python float is a product with the float's
# f32 reciprocal on the card), 2 sigma_r and 9; the gamma exponent.
SIGMA_S = 0.5
SIGMA_R = 0.1
W_S = tuple(float(np.exp(np.float32(-n / (2.0 * SIGMA_S * SIGMA_S))))
            for n in range(3))
INV_TWO_SIGMA_R = float(np.float32(1.0) / np.float32(2.0 * SIGMA_R))
INV_NINE = float(np.float32(1.0) / np.float32(9.0))
GAMMA = float(np.float32(1.0 / 2.2))

# Kernels a present launches (present.cu's two passes).
LAUNCHES = 2


def _check(accum, history, frame_count, average_jitter):
    """Raise unless the arguments fit the kernels; (H, W). Runs before
    any device work and never loads the kernel library."""
    if accum.dtype != torch.float32 or history.dtype != torch.float32:
        raise TypeError(f"accum, history: dtypes {accum.dtype}, "
                        f"{history.dtype}, expected torch.float32")
    if accum.dim() != 3 or accum.shape[2] != 4 or min(accum.shape) < 1:
        raise ValueError(f"accum: shape {tuple(accum.shape)}, expected "
                         "(H, W, 4)")
    H, W, _ = accum.shape
    if tuple(history.shape) != (H, W, 3):
        raise ValueError(f"history: shape {tuple(history.shape)}, expected "
                         f"{(H, W, 3)}")
    if average_jitter.dtype != torch.float32 or \
            tuple(average_jitter.shape) != (2,):
        raise ValueError(f"average_jitter: {average_jitter.dtype} "
                         f"{tuple(average_jitter.shape)}, expected "
                         "torch.float32 (2,)")
    if isinstance(frame_count, torch.Tensor) and (
            frame_count.dtype != torch.int64 or frame_count.dim() != 0):
        raise ValueError(f"frame_count: {frame_count.dtype} "
                         f"{tuple(frame_count.shape)}, expected a 0-d int64")
    for name, t in (("accum", accum), ("history", history),
                    ("average_jitter", average_jitter)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != accum.device:
            raise ValueError(f"{name}: on {t.device}, expected "
                             f"{accum.device}")
    return H, W


def present(accum: torch.Tensor, history: torch.Tensor, frame_count,
            average_jitter: torch.Tensor, unjitter: bool = True):
    """accum (H, W, 4) f32 sums and counts, history (H, W, 3) f32 (written
    with the new TAA history and returned), frame_count an int or a 0-d
    int64 tensor, average_jitter (2,) f32, all on one device ->
    (ldr (H, W, 3) uint8, history). The same image and history as
    `postprocess` bit for bit; unjitter=False skips the resample, as
    there."""
    H, W = _check(accum, history, frame_count, average_jitter)
    if accum.device.type == "cpu":
        ldr, new_history = postprocess(accum, history, frame_count,
                                       average_jitter, unjitter)
        return ldr, history.copy_(new_history)
    dev = accum.device
    kernels.check(accum, "accum", torch.float32, device=dev)
    if accum.data_ptr() % 16:
        raise ValueError("accum: must be 16-byte aligned")
    frame = frame_tensor(frame_count, dev)
    kernels.check(frame, "frame_count", torch.int64, (), dev)
    clean = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    ldr = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        code = lib.wrt_present(
            kernels.ptr(accum), H, W, kernels.ptr(clean), kernels.ptr(frame),
            kernels.ptr(average_jitter), int(unjitter), *W_S,
            INV_TWO_SIGMA_R, INV_NINE, GAMMA, kernels.ptr(history),
            kernels.ptr(ldr), kernels.stream(dev))
    kernels.raise_on_error(code, "present")
    kernels.launches["present"] += LAUNCHES
    return ldr, history
