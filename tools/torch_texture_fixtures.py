#!/usr/bin/env python3
"""The JPEG fixtures of the port's texture decoder, written by Pillow.

    python3 tools/torch_texture_fixtures.py     # needs Pillow (12.1.0)

writes `tests/fixtures/torch_textures/<name>.jpg` for each entry of
FIXTURES (a seeded smooth-plus-noise image saved with the entry's options)
and `digests.json`: per file the shape and SHA-256 of the bytes of
`np.asarray(Image.open(f).convert("RGB"))`, the JAX package's decode.
`tests/test_torch_cuda.py` holds the port's decodes to those digests on
the card's machine, which has no Pillow; `tests/test_torch_jpeg.py` writes
the files and digests again in memory and checks both against the
committed ones.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(REPO, "tests", "fixtures", "torch_textures")

# name -> (width, height, Pillow mode, seed, JPEG save options)
FIXTURES = {
    "baseline_420_odd": (211, 157, "RGB", 1,
                         dict(quality=90, subsampling="4:2:0")),
    "restart_422": (160, 96, "RGB", 2,
                    dict(quality=85, subsampling="4:2:2",
                         restart_marker_blocks=5)),
    "progressive_420": (173, 131, "RGB", 3,
                        dict(quality=80, subsampling="4:2:0",
                             progressive=True)),
    "grey": (97, 61, "L", 4, dict(quality=75)),
    "cmyk": (64, 48, "CMYK", 5, dict(quality=90)),
}


def source_pixels(width: int, height: int, channels: int,
                  seed: int) -> np.ndarray:
    """(height, width, channels) u8: `tests/torch_scenes.smooth_noise`,
    gradients plus seeded noise."""
    from tests.torch_scenes import smooth_noise

    return smooth_noise(height, width, channels, seed).astype(np.uint8)


def fixture_bytes(name: str) -> bytes:
    """The JPEG Pillow writes for fixture `name`."""
    from PIL import Image

    width, height, mode, seed, options = FIXTURES[name]
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    px = source_pixels(width, height, channels, seed)
    img = Image.fromarray(px[..., 0] if channels == 1 else px, mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **options)
    return buf.getvalue()


def reference_digest(data: bytes) -> dict:
    """Shape and SHA-256 of Pillow's open + convert("RGB") of `data`."""
    from PIL import Image

    rgb = np.ascontiguousarray(np.asarray(
        Image.open(io.BytesIO(data)).convert("RGB")))
    return {"shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main() -> None:
    os.makedirs(DIR, exist_ok=True)
    digests = {}
    for name in FIXTURES:
        data = fixture_bytes(name)
        with open(os.path.join(DIR, f"{name}.jpg"), "wb") as f:
            f.write(data)
        digests[f"{name}.jpg"] = reference_digest(data)
        print(f"{name}.jpg: {len(data)} bytes")
    with open(os.path.join(DIR, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, REPO)  # tests.torch_scenes, from any working directory
    main()
