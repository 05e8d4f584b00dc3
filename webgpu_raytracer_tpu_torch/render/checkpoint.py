"""Checkpoint / resume of progressive render state.

The port of the JAX package's `render/checkpoint.py`, in its format: a
`.npz` holding `accum`, `history` and `jitter_acc`, and a `.json` holding
the frame count, the size, depth, spp and scene. A checkpoint written by
either package loads in the other. The resumable state is the
accumulation buffer (sum + sample count) plus the frame counter and the
jitter accumulator; frames are counter-seeded, so a resumed run continues
bit for bit where the saved one left off.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def save_checkpoint(path: str, renderer) -> None:
    """Write the renderer's resumable state to `path` (.npz + .json)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path + ".npz",
        accum=renderer.accum.cpu().numpy(),
        history=renderer.history.cpu().numpy(),
        jitter_acc=np.asarray(renderer._jitter_acc.acc),
    )
    meta = {
        "frame_count": renderer.frame_count,
        "width": renderer.width,
        "height": renderer.height,
        "max_depth": renderer.max_depth,
        "spp": renderer.spp,
        "scene_name": renderer.config.scene_name,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, renderer) -> bool:
    """Restore a renderer's state onto its device; returns False, and
    changes nothing, when the files are missing or unreadable or the size,
    depth or spp differ."""
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
        data = np.load(path + ".npz")
    except (OSError, ValueError):
        return False
    if (meta["width"] != renderer.width or meta["height"] != renderer.height
            or meta["max_depth"] != renderer.max_depth
            or meta["spp"] != renderer.spp):
        return False
    dev = renderer.device
    renderer.accum = torch.from_numpy(
        np.asarray(data["accum"], np.float32)).to(dev)
    renderer.history = torch.from_numpy(
        np.asarray(data["history"], np.float32)).to(dev)
    renderer._jitter_acc.acc = np.asarray(data["jitter_acc"], np.float64)
    renderer.frame_count = int(meta["frame_count"])
    return True
