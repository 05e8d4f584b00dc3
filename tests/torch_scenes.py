"""Scenes, fixtures and holds that the port's tests and `chip_smoke.py`
share. Imports no JAX and no PIL, so it runs on a machine with the card.

- GLBs written with numpy alone: the textured quad (`textured_quad_glb`,
  the PIL-free twin of `tests/glb_fixture.textured_quad_glb`), the quad
  as a textured light (`textured_light_glb`) and the texture formats scene
  (`formats_scene_glb`: a 4:2:0 JPEG, a progressive JPEG, a 16-bit Adam7
  PNG and a 4-bit palette PNG in the four texture slots; with twin=True
  the port's decodes of them as 8-bit PNGs); `png_bytes` writes PNGs at
  any depth, filter and interlace.
- `textured_scene`: a GLB's tables, camera and texture pyramid on a
  device; `bvh_scene`: a preset's or a GLB's DeviceScene and camera.
- The BVH bounce: `bvh_bounce_inputs` (the arguments entering a bounce of
  a DEPTH frame, advanced through the kernels) and `hold_bvh_shade` (the
  kernel against its plain step); the BVH walk: `walk_bit_equal` and
  `poison_lanes` (lanes of NaN / inf).
- `fma_rounding`: a true f32 fused multiply-add beside the plain
  sampler's f64 emulation of one.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from webgpu_raytracer_tpu_torch import NativeWorld
from webgpu_raytracer_tpu_torch.ops import bvh_shade, intersect
from webgpu_raytracer_tpu_torch.ops.dense_trace import pinhole_rays
from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
from webgpu_raytracer_tpu_torch.ops.intersect import T_MIN
from webgpu_raytracer_tpu_torch.ops.rng import init_rng, rand_n
from webgpu_raytracer_tpu_torch.render.resources import build_device_scene
from webgpu_raytracer_tpu_torch.render.worldtris import build_world_tables
from webgpu_raytracer_tpu_torch.utils.images import png_rgb
from webgpu_raytracer_tpu_torch.utils.jpeg import decode_jpeg
from webgpu_raytracer_tpu_torch.utils.textures import (build_quad_pyramid,
                                                       decode_png,
                                                       decode_world_textures)

DEPTH = 8  # max_depth of the frames whose bounces the holds are given


def pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def glb(doc: dict, blobs: list[bytes]) -> bytes:
    """A GLB container: the JSON chunk, then the binary chunk holding
    `blobs` each padded to 4 bytes (doc's bufferViews must match)."""
    js = pad4(json.dumps(doc).encode(), b" ")
    bin_data = b"".join(pad4(b) for b in blobs)
    total = 12 + 8 + len(js) + 8 + len(bin_data)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data)


def quad_glb(images: list[tuple[bytes, str]], material: dict) -> bytes:
    """The textured quad's geometry (a unit quad at y = 1, normals +z,
    UVs over [0, 1]^2) with `images` ((bytes, mimeType) each, texture i
    reading image i) and one `material`."""
    positions = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blobs = [positions.tobytes(), normals.tobytes(), uvs.tobytes(),
             indices.tobytes()] + [data for data, _ in images]
    offsets = np.cumsum([0] + [len(pad4(b)) for b in blobs[:-1]]).tolist()
    bin_data = b"".join(pad4(b) for b in blobs)
    views = [48, 48, 32, 12] + [len(data) for data, _ in images]
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0.0, 1.0, 0.0]}],
        "buffers": [{"byteLength": len(bin_data)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n}
                        for o, n in zip(offsets, views)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "images": [{"bufferView": 4 + i, "mimeType": mime}
                   for i, (_, mime) in enumerate(images)],
        "textures": [{"source": i} for i in range(len(images))],
        "materials": [material],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3,
            "material": 0,
        }]}],
    }
    return glb(doc, blobs)


def textured_quad_glb() -> bytes:
    """tests/glb_fixture.textured_quad_glb without PIL: the same quad and
    the same 8x8 image, left half red and right half blue, as a PNG
    baseColorTexture."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 0, 255]
    return quad_glb([(png_rgb(img), "image/png")], {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0,
        },
    })


def textured_light_glb() -> bytes:
    """The quad as a light (emissiveFactor 1) whose base colour is a
    37x53 texture of smooth noise: NEE samples read the light's texture."""
    img = smooth_noise(37, 53, 3, 5).astype(np.uint8)
    return quad_glb([(png_rgb(img), "image/png")], {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
        },
        "emissiveFactor": [1.0, 1.0, 1.0],
    })


def textured_scene(glb_data: bytes, width: int, height: int, dev,
                   fifth: bool = False) -> tuple:
    """(tables, camera, texture pyramid) of a GLB in the viewer scene.
    fifth=True adds a fifth layer (the first with its channels reversed),
    so that k * 128^2 > KRON_MAX_ROWS and level 1 is level 0."""
    world = NativeWorld("viewer", glb_data=glb_data)
    world.update_camera(width, height)
    tables = build_world_tables(world, dev)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    decoded = decode_world_textures(world)
    if fifth:
        decoded = np.concatenate([decoded, decoded[:1, ..., ::-1]])
    return tables, camera, device_pyramid(build_quad_pyramid(decoded), dev)



ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy)


def png_bytes(px, color_type: int, filters=(0,), palette=None,
              depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of (H, W, C) samples below 2^depth, written without PIL.

    Samples are packed at `depth` bits (MSB first below 8 bits, big-endian
    at 16), each row byte-padded; with interlace 1 the image goes as the
    seven Adam7 passes, each a sub-image with its own filtered rows (a pass
    with no columns or rows writes nothing). Row y of a pass takes filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    over bytes, `bpp` = max(1, C * depth // 8) apart."""
    px = np.asarray(px, np.int64)
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(
                np.uint8)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
        else:
            bits = (sub.reshape(sub.shape[0], -1, 1)
                    >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(sub.shape[0], -1).astype(
                np.uint8), axis=1)
        rows = rows.astype(np.int64)
        prior = np.zeros(rows.shape[1], np.int64)
        zero = np.zeros(bpp, np.int64)
        for y, cur in enumerate(rows):
            left = np.concatenate([zero, cur[:-bpp]])[:cur.size]
            upleft = np.concatenate([zero, prior[:-bpp]])[:cur.size]
            f = filters[y % len(filters)]
            if f == 0:
                pred = 0
            elif f == 1:
                pred = left
            elif f == 2:
                pred = prior
            elif f == 3:
                pred = (left + prior) >> 1
            else:
                p = left + prior - upleft
                pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                              np.abs(p - upleft))
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, upleft))
            raw += bytes([f]) + ((cur - pred) & 0xFF).astype(
                np.uint8).tobytes()
            prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")



FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "torch_textures")
# emissiveFactor of the formats quad: |f|^2 = 9.7e-5 stays under the scene
# compiler's 1e-4 light threshold, so the quad is no light and its emission
# is this factor times the emissive texture.
FORMATS_EMISSIVE = 0.0057


def smooth_noise(height: int, width: int, channels: int, seed: int,
                 top: int = 255) -> np.ndarray:
    """(height, width, channels) int64 samples in [0, top]: gradients plus
    seeded noise."""
    rs = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    k = np.arange(channels)
    base = 0.5 + 0.4 * np.sin(x[..., None] / (0.01 * width + 7 * k + 5)
                              + y[..., None] / (0.013 * height + 5 * k + 3))
    noise = rs.normal(0, 0.04, base.shape)
    return np.clip(np.rint((base + noise) * top), 0, top).astype(np.int64)


def formats_images() -> list[tuple[str, bytes, np.ndarray | None]]:
    """The four images of the formats scene, in texture order (base
    colour, metallic-roughness, normal, emissive): (name, bytes, the RGB
    Pillow gives, or None where `digests.json` holds it). The JPEGs are
    the committed fixtures; the PNGs are written here."""
    out = []
    for name in ("baseline_420_odd", "progressive_420"):
        with open(os.path.join(FIXTURE_DIR, f"{name}.jpg"), "rb") as f:
            out.append((f"{name}.jpg", f.read(), None))
    normal = smooth_noise(47, 61, 3, 7, top=65535)
    out.append(("normal, 16-bit RGB Adam7 PNG 61x47",
                png_bytes(normal, 2, filters=(0, 1, 2, 3, 4), depth=16,
                          interlace=1), (normal >> 8).astype(np.uint8)))
    rs = np.random.default_rng(8)
    palette = rs.integers(0, 256, (16, 3))
    index = smooth_noise(29, 37, 1, 9, top=15)
    out.append(("emissive, 4-bit palette PNG 37x29",
                png_bytes(index, 3, filters=(0, 1, 2, 3, 4),
                          palette=palette, depth=4),
                palette[index[..., 0]].astype(np.uint8)))
    return out


def formats_glb(images: list[bytes], mimes: list[str]) -> bytes:
    """The textured quad with one image in each texture slot the scene
    compiler reads: base colour, metallic-roughness (metallicFactor 1, so
    the texture's blue channel is the metalness), normal and emissive."""
    return quad_glb(list(zip(images, mimes)), {
        "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "baseColorTexture": {"index": 0},
            "metallicFactor": 1.0,
            "roughnessFactor": 1.0,
            "metallicRoughnessTexture": {"index": 1},
        },
        "normalTexture": {"index": 2},
        "emissiveTexture": {"index": 3},
        "emissiveFactor": [FORMATS_EMISSIVE] * 3,
    })


def formats_scene_glb(twin: bool = False) -> bytes:
    """The texture formats scene; with twin=True the same scene whose four
    images are the port's decodes of them, written as 8-bit RGB PNGs."""
    images = [data for _, data, _ in formats_images()]
    if twin:
        return formats_glb([png_rgb(decode_image(d)) for d in images],
                           ["image/png"] * 4)
    return formats_glb(images, ["image/jpeg"] * 2 + ["image/png"] * 2)


def decode_image(data: bytes) -> np.ndarray:
    return decode_png(data) if data.startswith(b"\x89PNG") \
        else decode_jpeg(data)



def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| over the entries that differ; 0.0 when a == b
    everywhere (equal infinities, NaN against NaN and the 3e38 of a dropped
    cluster included)."""
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    return float(torch.where(same, 0.0, (a - b).abs()).max())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality of two 32-bit tensors (f32 compared as int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)



def fma_rounding(a, b, c) -> tuple:
    """a * b + c of f32 tensors: (rounded through f64 as the plain
    sampler's `_fma_v3` rounds it, rounded once as one f32 fused
    multiply-add). a * b is exact in f64 and TwoSum gives the f64 sum's
    error e, so the two part only where the sum lands on the midpoint of
    two f32 values with e != 0: the true fma rounds toward e's side, the
    f64 path to the even neighbour, one ulp apart."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.inf, -torch.inf).to(torch.float32)
    n = torch.nextafter(r, toward)
    mid = (d != 0) & (r.double() + n.double() == 2.0 * s)
    up = mid & (e != 0) & ((e > 0) == (d > 0))
    return r, torch.where(up, n, r)



def poison_lanes(ro, rd, t_max, seed: int):
    """Copies of a stack with every 3rd lane given NaN, +inf or -inf in one
    component of o or of d, or in t_max (a float t_max becomes per lane)."""
    R, dev = ro.shape[0], ro.device
    rs = np.random.default_rng(seed)
    ro, rd = ro.cpu().numpy().copy(), rd.cpu().numpy().copy()
    tm = (t_max.cpu().numpy().copy() if isinstance(t_max, torch.Tensor)
          else np.full(R, t_max, np.float32))
    bad = np.arange(0, R, 3)
    what = rs.integers(0, 7, bad.size)  # 0-2 o, 3-5 d, 6 t_max
    val = np.array([np.nan, np.inf, -np.inf], np.float32)[
        rs.integers(0, 3, bad.size)]
    for k in range(3):
        ro[bad[what == k], k] = val[what == k]
        rd[bad[what == k + 3], k] = val[what == k + 3]
    tm[bad[what == 6]] = val[what == 6]
    return tuple(torch.from_numpy(x).to(dev) for x in (ro, rd, tm))



def walk_bit_equal(scene, ro, rd, t_max, active, any_hit, label,
                   pack) -> tuple:
    """The kernel twice (over `pack`) and the plain walk once on the same
    CUDA tensors: results and counts bit for bit. Returns (kernel out,
    stats, measured error): the largest |t - t_plain| of the closest walk,
    or of the occluded flags as 0 / 1 in any-hit mode, over both
    launches."""
    runs = [intersect.walk_cuda(scene, ro, rd, T_MIN, t_max, active,
                                any_hit, True, pack) for _ in range(2)]
    plain, pst = intersect.traverse_plain(scene, ro, rd, T_MIN, t_max,
                                          active, any_hit)
    torch.cuda.synchronize()
    want = (plain, *pst) if any_hit else (*plain, *pst)
    for out, st in runs:
        got = (out, *st) if any_hit else (*out, *st)
        for a, b in zip(got, want):
            assert bits_equal(a, b), f"bvh walk {label}: kernel != plain"

    def first(x):  # the occluded flags, or the closest walk's t
        return x if any_hit else x.t

    err = max(max_abs_diff(first(out), first(plain)) for out, _ in runs)
    out, st = runs[0]
    frac = float((out if any_hit else out.inst_idx >= 0).float().mean())
    print(f"bvh walk {label}: {'occluded' if any_hit else 'hit'} "
          f"{frac:.4f} of {ro.shape[0]} lanes, nodes visited "
          f"{float(st.nodes.float().mean()):.2f} a lane (max "
          f"{int(st.nodes.max())}), triangles tested "
          f"{float(st.tris.float().mean()):.2f}; bit-equal to the plain "
          f"walk (t, tri, inst / occluded, counts), two launches, max abs "
          f"err {err}")
    return out, st, err



def bvh_scene(name: str, width: int, height: int, dev,
              glb_data: bytes | None = None) -> tuple:
    """(DeviceScene, camera) of a preset, or of a GLB in the viewer scene
    with its textures decoded into the level-0 quad table."""
    world = NativeWorld(name, glb_data=glb_data)
    world.update_camera(width, height)
    camera = torch.from_numpy(np.asarray(world.camera(), np.float32)).to(dev)
    return build_device_scene(world, textures=decode_world_textures(world),
                              device=dev), camera


def shade_kw(scene) -> dict:
    """`bvh_shade`'s keywords for a CUDA scene: its ShadePack, built once;
    none on the CPU, where the pack is not read."""
    if scene.tri_v.device.type != "cuda":
        return {}
    return {"pack": bvh_shade.pack_shade(scene)}


def bvh_bounce_inputs(scene, camera, width, height, depth: int,
                      pack=None, kw=None) -> tuple:
    """`bvh_shade`'s arguments entering bounce `depth` of a BVH frame of
    depth DEPTH: `pinhole_rays` and frame 1's rng streams past the lens
    draws, advanced through the shade kernel and the walks on the card
    (their plain versions on the CPU), as `ray_color_rows` advances them.
    `pack` is the walks' WalkPack, `kw` the shade's (`shade_kw`)."""
    kw = shade_kw(scene) if kw is None else kw

    ro3, rd3 = pinhole_rays(camera, width, height)
    ro = torch.stack(list(ro3), 1).contiguous()
    rd = torch.stack(list(rd3), 1).contiguous()
    R = width * height
    rng, _ = rand_n(init_rng(torch.arange(R, device=ro.device), 1), 2)
    hit = intersect.intersect_closest(scene, ro, rd, pack=pack)
    state = bvh_shade.initial_state(R, ro.device)
    active = occluded = None
    for d in range(depth):
        state, rng, nxt = bvh_shade.bvh_shade(
            scene, state, rng, ro, rd, active, hit.tri_idx, hit.inst_idx,
            occluded, d, DEPTH, **kw)
        occluded = intersect.intersect_shadow(
            scene, nxt.sro, nxt.srd, nxt.s_tmax, active=nxt.nee_lane,
            pack=pack)
        ro, rd, active = nxt.ro, nxt.rd, nxt.do_next
        hit = intersect.intersect_closest(scene, ro, rd, active=active,
                                          pack=pack)
    return (scene, state, rng, ro, rd, active, hit.tri_idx, hit.inst_idx,
            occluded, depth, DEPTH)


def near_mirror(args) -> torch.Tensor:
    """Lanes that sample GGX near its roughness floor (a metal whose
    roughness is under 0.01, or scaled by a texture), where
    `1 + (a*a - 1) * r2` cancels and an ulp of sin / cos moves the pdf."""
    scene, tri = args[0], args[6]
    t = tri.clamp(0, scene.tri_v.shape[0] - 1).long()
    return (scene.tri_mat[t] == 1) & ((scene.tri_mrir[t, 1] < 0.01)
                                      | (scene.tri_tex[t, 1] >= 0))


def hold_bvh_shade(label: str, args: tuple) -> float:
    """The BVH shade kernel against `bvh_shade_step` on one bounce's
    inputs: rng words equal; the flags (specular, pend, do_next, nee_lane)
    equal on every lane; every other output (state rows, rays, t_max)
    within rtol 1e-4 / atol 1e-5 on every lane but near-mirror GGX ones,
    held at 5e-2. Returns the largest |error| outside the near-mirror
    lanes."""
    out_k, rng_k, nxt_k = bvh_shade.bvh_shade(*args)
    out_p, rng_p, nxt_p = bvh_shade.bvh_shade_step(*args)
    torch.cuda.synchronize()
    assert torch.equal(rng_k, rng_p), f"{label}: rng words differ"
    flag_rows = list(bvh_shade.FLAG_ROWS)
    flags = ((out_k[flag_rows] == out_p[flag_rows]).all(0)
             & (nxt_k.do_next == nxt_p.do_next)
             & (nxt_k.nee_lane == nxt_p.nee_lane))
    rows = [r for r in range(bvh_shade.NS) if r not in flag_rows]

    def values(out, nxt):  # (K, R) of every non-flag output
        return torch.cat([out[rows], nxt.ro.T, nxt.rd.T, nxt.sro.T,
                          nxt.srd.T, nxt.s_tmax[None]])

    vk, vp = values(out_k, nxt_k), values(out_p, nxt_p)
    assert bool(torch.isfinite(vk).all()), f"{label}: non-finite output"
    mirror = near_mirror(args)
    close = torch.isclose(vk, vp, rtol=1e-4, atol=1e-5).all(0)
    close_m = torch.isclose(vk, vp, rtol=5e-2, atol=1e-5).all(0)
    held = torch.where(mirror, close_m, close)
    err = float((vk - vp).abs()[:, ~mirror].max()) if bool(
        (~mirror).any()) else 0.0
    equal = float((vk == vp).all(0).float().mean())
    found = args[7] >= 0 if args[5] is None else args[5] & (args[7] >= 0)
    mirror_held = float(close_m[mirror].float().mean()) if bool(
        mirror.any()) else 1.0
    print(f"bvh shade {label}: flags equal on "
          f"{float(flags.float().mean()):.6f} of lanes, values close on "
          f"{float(close.float().mean()):.6f} (near-mirror lanes "
          f"{int(mirror.sum())}, {mirror_held:.6f} of them at 5e-2), "
          f"bit-equal {equal:.6f}, max abs err {err:.3e}; found "
          f"{float(found.float().mean()):.3f}, nee "
          f"{float(nxt_k.nee_lane.float().mean()):.3f}, next "
          f"{float(nxt_k.do_next.float().mean()):.3f}")
    assert bool(flags.all()), f"{label}: flags differ"
    assert bool(held.all()), f"{label}: values differ"
    return err

