"""The port's product surface against the JAX package, on the CPU.

- app shell (twins of tests/test_app_shell.py): clip selection through
  `RenderConfig.anim_index` and `set_animation`, with the tables after
  `update_scene(0.5)` bit-equal to JAX `build_world_tris` for both clips of
  the two-clip skinned strip; `cli render --animate` and `cli render
  --preview 0` with `--device cpu`; the preview server's MJPEG stream,
  whose JPEG part decodes (Pillow, here only) to the published size within
  a mean error of 3 codes.
- `Renderer.update_screen_size` against the JAX package: the same camera,
  buffers of the new shape, and the next frame within the tolerance of
  tests/test_torch_slice.py::test_trace_matches_jax (>= 95% of lanes at
  rel < 1e-3, means within 2%).
- the bridge overlap (the next tick on the bridge's thread while the frame
  renders) gives the frames of sequential `update_scene(t)` ticks bit for
  bit, on the skinned strip.
- the CLI: `info` prints the JAX CLI's counts; `render --scene spheres
  --device cpu` renders through the BVH path, as `Renderer` does; `render`
  writes PNG or JPEG by extension and refuses other extensions.
- checkpoint (twins of tests/test_checkpoint.py), and a checkpoint written
  by either package loads in the other with `accum`, `history`, the jitter
  accumulator and `frame_count` equal.
- recorder (twins of tests/test_recorder.py), and `record_chunks`' frames
  against the JAX recorder's at 32^2 d3 spp 2: LDR within 1 code on >= 99%
  of pixels (the present tolerance of test_postprocess_matches_jax); at
  spp 64 both recorders' frames are dark alike (a reference behaviour).
- the image writers: PNG and JPEG decode (Pillow) to the image; the JPEG
  tables are Pillow's standard ones; `utils/profiling` on the CPU.
"""

import contextlib
import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from webgpu_raytracer_tpu import Renderer as JaxRenderer
from webgpu_raytracer_tpu import cli as jax_cli
from webgpu_raytracer_tpu.config import RenderConfig as JaxConfig
from webgpu_raytracer_tpu.models.native import NativeWorld as JaxWorld
from webgpu_raytracer_tpu.render import checkpoint as jax_checkpoint
from webgpu_raytracer_tpu.render.recorder import \
    VideoRecorder as JaxRecorder
from webgpu_raytracer_tpu.render.worldtris import build_world_tris
from webgpu_raytracer_tpu_torch import Renderer, RenderConfig, cli
from webgpu_raytracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
from webgpu_raytracer_tpu_torch.render.preview import PreviewServer
from webgpu_raytracer_tpu_torch.render.recorder import (AbortFlag,
                                                        VideoRecorder,
                                                        mux_frames)
from webgpu_raytracer_tpu_torch.utils import images
from webgpu_raytracer_tpu_torch.utils.profiling import (FrameStats,
                                                        device_trace, span,
                                                        spans, tracing)
from webgpu_raytracer_tpu_torch.utils.textures import decode_png

from tests import torch_scenes
from tests.glb_fixture import skinned_strip_glb, two_clip_skinned_glb

KEYS = ("features", "shade_table", "light_rows", "light_count",
        "valid_count")


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- app shell ----------------------------------------------------------------

def _clip_tables_equal_jax(r, clip, t):
    """The port renderer's tables equal JAX `build_world_tris` of a JAX
    world on the same clip at time t, bit for bit."""
    world = JaxWorld("viewer", glb_data=two_clip_skinned_glb())
    world.set_animation(clip)
    world.update(t)
    world.update_camera(r.width, r.height)
    ref = build_world_tris(world)
    got = r.tables
    for key in KEYS:
        want = np.asarray(getattr(ref, key))
        have = getattr(got, key)
        have = have.numpy() if isinstance(have, torch.Tensor) else have
        np.testing.assert_array_equal(have, want, err_msg=key)


def test_anim_index_selects_clip():
    """anim_index selects the clip at construction: 'sway' (joint +x) and
    'lift' (joint +y) deform the strip differently at t = 0.5, and each
    renderer's tables are JAX's for its clip."""
    glb = two_clip_skinned_glb()
    r0 = Renderer("viewer", glb_data=glb,
                  config=RenderConfig(width=16, height=16, anim_index=0),
                  device="cpu")
    r1 = Renderer("viewer", glb_data=glb,
                  config=RenderConfig(width=16, height=16, anim_index=1),
                  device="cpu")
    assert r0.world.animation_count() == 2
    assert [r0.world.animation_name(i) for i in range(2)] == ["sway", "lift"]
    r0.update_scene(0.5)
    r1.update_scene(0.5)
    v0 = np.asarray(r0.world.vertices())
    v1 = np.asarray(r1.world.vertices())
    assert v0.shape == v1.shape and not np.allclose(v0, v1)
    _clip_tables_equal_jax(r0, 0, 0.5)
    _clip_tables_equal_jax(r1, 1, 0.5)


def test_set_animation_switches_clip():
    r = Renderer("viewer", glb_data=two_clip_skinned_glb(),
                 config=RenderConfig(width=16, height=16), device="cpu")
    r.update_scene(0.5)
    before = np.asarray(r.world.vertices()).copy()
    r.render_frame()
    r.set_animation(1, time=0.5)
    after = np.asarray(r.world.vertices())
    assert not np.allclose(before, after)
    assert r.config.anim_index == 1
    assert r.frame_count == 0  # set_animation resets accumulation
    _clip_tables_equal_jax(r, 1, 0.5)
    assert r.load_animation_glb(two_clip_skinned_glb())
    assert r.world.animation_count() == 4


def test_pil_free_textured_quad_fixture_decodes_red_and_blue():
    """`torch_scenes.textured_quad_glb` (written without PIL, for the
    card's machine) decodes to the fixture's texture: one 1024^2 layer,
    exactly red left of column 448 and exactly blue from column 576 (a
    decode that failed would fill 0.8 grey), a (1024^2, 128^2) pyramid,
    one bound slot (base colour) and no textured light."""
    from webgpu_raytracer_tpu_torch import NativeWorld
    from webgpu_raytracer_tpu_torch.ops.fetch import device_pyramid
    from webgpu_raytracer_tpu_torch.render.worldtris import \
        build_world_tables
    from webgpu_raytracer_tpu_torch.utils.textures import (
        build_quad_pyramid, decode_world_textures)

    world = NativeWorld("viewer", glb_data=torch_scenes.textured_quad_glb())
    world.update_camera(16, 16)
    decoded = decode_world_textures(world)
    assert decoded is not None and decoded.shape == (1, 1024, 1024, 3)
    np.testing.assert_array_equal(decoded[0, :, :448], np.broadcast_to(
        np.float32([1, 0, 0]), (1024, 448, 3)))
    np.testing.assert_array_equal(decoded[0, :, 576:], np.broadcast_to(
        np.float32([0, 0, 1]), (1024, 448, 3)))
    level0, level1 = device_pyramid(build_quad_pyramid(decoded), "cpu")
    assert level0.shape == (1, 1024, 1024) and level1.shape == (1, 128, 128)
    tables = build_world_tables(world, "cpu")
    assert tables.tex_slots == (True, False, False, False)
    assert not tables.light_tex


def test_bridge_is_the_renderers_world():
    r = Renderer("cornell", config=RenderConfig(width=8, height=8),
                 device="cpu")
    assert r.bridge.world is r.world and r.backend == "dense"


def test_cli_animated_render(tmp_path):
    glb_path = tmp_path / "strip.glb"
    glb_path.write_bytes(two_clip_skinned_glb())
    out = tmp_path / "anim.png"
    cli.main([
        "render", "--scene", "viewer", "--model", str(glb_path),
        "--width", "32", "--height", "32", "--depth", "3",
        "--frames", "6", "--animate", "--update-interval", "2",
        "--fps", "8", "--anim", "1", "--output", str(out),
        "--device", "cpu",
    ])
    img = _decode(out.read_bytes())
    assert img.shape == (32, 32, 3)
    assert img.mean() > 1.0  # not black


def test_cli_render_preview_smoke(tmp_path):
    out = tmp_path / "p.png"
    cli.main(["render", "--scene", "cornell", "--width", "16", "--height",
              "16", "--depth", "2", "--frames", "2", "--preview", "0",
              "--output", str(out), "--device", "cpu"])
    assert _decode(out.read_bytes()).shape == (16, 16, 3)


JPEG_MEAN_ERR = 3.0  # codes, mean over all pixels and channels


def test_preview_server_streams_frames():
    """The / page serves, /stats reflects the latest publish, and /stream
    yields one JPEG part per published frame that decodes to the published
    size within JPEG_MEAN_ERR of the image."""
    srv = PreviewServer(port=0)
    try:
        yy, xx = np.mgrid[0:24, 0:32]
        img = np.stack([xx * 8, yy * 10, 255 - xx * 8], -1).astype(np.uint8)
        img[:, :16, 0] = 255
        srv.publish(img, stats="fps=1.0")
        base = f"http://127.0.0.1:{srv.port}"
        assert b"/stream" in urllib.request.urlopen(base + "/",
                                                    timeout=5).read()
        assert urllib.request.urlopen(base + "/stats",
                                      timeout=5).read() == b"fps=1.0"
        resp = urllib.request.urlopen(base + "/stream", timeout=5)
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]

        def read_part():
            assert resp.readline().strip() == b"--frame"
            headers = {}
            while True:
                line = resp.readline().strip()
                if not line:
                    break
                k, v = line.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
            body = resp.read(int(headers[b"content-length"]))
            resp.readline()
            return body

        part = read_part()
        decoded = _decode(part)
        assert decoded.shape == img.shape
        err = np.abs(decoded.astype(np.int32) - img).mean()
        assert err < JPEG_MEAN_ERR, err
        srv.publish(np.full((24, 32, 3), 200, np.uint8))
        part2 = read_part()
        assert part2 != part
        assert np.abs(_decode(part2).astype(np.int32) - 200).max() <= 1
    finally:
        srv.close()


# -- resize -------------------------------------------------------------------

def test_update_screen_size_matches_jax():
    cfg = dict(width=24, height=16, max_depth=4)
    jr = JaxRenderer("cornell", config=JaxConfig(**cfg))
    r = Renderer("cornell", config=RenderConfig(**cfg), device="cpu")
    for x in (jr, r):
        x.render_frame()
        x.update_screen_size(40, 32)
    np.testing.assert_array_equal(r.camera.numpy(), np.asarray(jr.camera))
    assert r.accum.shape == (40 * 32, 4) and r.accum.device.type == "cpu"
    assert r.history.shape == (32, 40, 3)
    assert float(r.history.abs().sum()) == 0.0 and r.frame_count == 0
    jr.render_frame()
    r.render_frame()
    a = np.asarray(jr.accum)[:, :3]
    b = r.accum.numpy()[:, :3]
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(a).max(1), 1e-3)
    assert (rel < 1e-3).mean() >= 0.95
    assert abs(a.mean() - b.mean()) < 0.02 * max(a.mean(), 1e-3)
    assert r.present().shape == (32, 40, 3)


# -- the bridge overlap -------------------------------------------------------

def _skinned(res=16):
    return Renderer("viewer", glb_data=skinned_strip_glb(),
                    config=RenderConfig(width=res, height=res, max_depth=3),
                    device="cpu")


def test_bridge_overlap_bit_equal_to_sequential_ticks():
    """bench.py's anim_pass order (wait, reupload, kick the next tick,
    render) against `update_scene(t)` then render, frame by frame."""
    over, seq = _skinned(), _skinned()
    times = [(1 + k) / 30.0 for k in range(5)]
    over.bridge.update_async(times[0])
    for k, t in enumerate(times):
        over.bridge.wait()
        over.reupload_scene()
        if k + 1 < len(times):
            over.bridge.update_async(times[k + 1])
        over.render_frame()
        seq.update_scene(t)
        seq.render_frame()
        assert torch.equal(over.accum.view(torch.int32),
                           seq.accum.view(torch.int32)), k
        np.testing.assert_array_equal(over.present(), seq.present())
    assert float(over.accum[:, :3].mean()) > 0.01


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("scene,glb", [("cornell", None), ("mixed", None),
                                       ("viewer", two_clip_skinned_glb)])
def test_cli_info_matches_jax(tmp_path, scene, glb):
    argv = ["info", "--scene", scene]
    if glb is not None:
        path = tmp_path / "m.glb"
        path.write_bytes(glb())
        argv += ["--model", str(path)]
    outs = []
    for main in (jax_cli.main, cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "triangles:" in outs[1]


def test_cli_spheres_on_cpu_not_ported(tmp_path):
    """`render --scene spheres --device cpu` renders through the BVH path
    (the name is from before that path was ported) and writes a PNG that
    decodes to 8x8."""
    out = tmp_path / "s.png"
    cli.main(["render", "--scene", "spheres", "--width", "8", "--height",
              "8", "--depth", "2", "--frames", "1", "--device", "cpu",
              "--output", str(out)])
    assert _decode(out.read_bytes()).shape == (8, 8, 3)


def test_cli_output_formats(tmp_path):
    argv = ["render", "--scene", "cornell", "--width", "16", "--height",
            "12", "--depth", "2", "--frames", "2", "--device", "cpu"]
    cli.main(argv + ["--output", str(tmp_path / "o.jpg")])
    data = (tmp_path / "o.jpg").read_bytes()
    assert data[:2] == b"\xff\xd8" and _decode(data).shape == (12, 16, 3)
    with pytest.raises(ValueError, match="png"):
        cli.main(argv + ["--output", str(tmp_path / "o.bmp")])
    assert not (tmp_path / "o.bmp").exists()


# -- checkpoint ---------------------------------------------------------------

CKPT = dict(width=24, height=24, max_depth=3, shader_spp=1)


def test_checkpoint_roundtrip(tmp_path):
    r = Renderer("cornell", config=RenderConfig(**CKPT), device="cpu")
    for _ in range(3):
        r.render_frame()
    r.present()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, r)
    r2 = Renderer("cornell", config=RenderConfig(**CKPT), device="cpu")
    assert load_checkpoint(path, r2)
    assert r2.frame_count == r.frame_count
    assert torch.equal(r2.accum, r.accum)
    assert torch.equal(r2.history, r.history)
    r.render_frame()
    r2.render_frame()
    assert torch.equal(r2.accum, r.accum)


def test_checkpoint_rejects_mismatch(tmp_path):
    r = Renderer("cornell", config=RenderConfig(**CKPT), device="cpu")
    r.render_frame()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, r)
    other = Renderer("cornell", config=RenderConfig(
        **{**CKPT, "width": 32, "height": 32}), device="cpu")
    accum = other.accum
    assert not load_checkpoint(path, other)
    assert other.frame_count == 0 and other.accum is accum


def test_checkpoint_missing(tmp_path):
    r = Renderer("cornell", config=RenderConfig(**CKPT), device="cpu")
    assert not load_checkpoint(str(tmp_path / "nope"), r)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    jr = JaxRenderer("cornell", config=JaxConfig(**CKPT))
    r = Renderer("cornell", config=RenderConfig(**CKPT), device="cpu")
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        src, dst, save, load = jr, r, jax_checkpoint.save_checkpoint, \
            load_checkpoint
    else:
        src, dst, save, load = r, jr, save_checkpoint, \
            jax_checkpoint.load_checkpoint
    for _ in range(3):
        src.render_frame()
        src.present()
    save(path, src)
    assert load(path, dst)
    for name in ("accum", "history"):
        a, b = np.asarray(getattr(src, name)), np.asarray(getattr(dst, name))
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(src._jitter_acc.acc, dst._jitter_acc.acc)
    assert dst._jitter_acc.acc.dtype == np.float64
    assert dst.frame_count == src.frame_count == 3


# -- recorder -----------------------------------------------------------------

REC = dict(width=32, height=32, max_depth=3, shader_spp=1, fps=10,
           duration=0.3, spp=2, batch=2)


@pytest.fixture(scope="module")
def renderer():
    return Renderer("cornell", config=RenderConfig(**REC), device="cpu")


def test_record_chunks(renderer):
    rec = VideoRecorder(renderer)
    frames = rec.record_chunks(renderer.config, start_frame=0, frame_count=3)
    assert [f.frame_index for f in frames] == [0, 1, 2]
    assert frames[0].key_frame
    assert all(f.data.startswith(b"\x89PNG") for f in frames)
    assert rec.last_batch >= 1
    for f in frames:
        img = decode_png(f.data)
        assert img.shape == (32, 32, 3) and img.mean() > 1.0
        np.testing.assert_array_equal(img, _decode(f.data))


def test_record_chunks_abort(renderer):
    abort = AbortFlag()
    abort.abort()
    assert VideoRecorder(renderer).record_chunks(renderer.config, 0, 3,
                                                 abort=abort) == []


def test_mux_frames(tmp_path, renderer):
    frames = VideoRecorder(renderer).record_chunks(renderer.config, 0, 2)
    frames.append(frames[0])  # a duplicate: deduped by frame index
    out = mux_frames(frames, fps=10, output=str(tmp_path / "clip"))
    assert os.path.exists(out)
    assert len(os.listdir(str(tmp_path / "clip_frames"))) == 2


def test_record_full(tmp_path, renderer):
    result = VideoRecorder(renderer).record(renderer.config,
                                            output=str(tmp_path / "anim"))
    assert len(result.frames) == int(renderer.config.fps
                                     * renderer.config.duration)
    assert result.output_path is not None


def test_record_chunks_matches_jax():
    """The same sequence through both recorders (bootstrap, 5 warm-up
    frames, per frame a tick, 2 samples and a present), on the skinned
    strip so that the frames differ: LDR within 1 code on >= 99%."""
    glb = skinned_strip_glb()
    cfg = dict(REC, scene_name="viewer")
    jax_frames = JaxRecorder(JaxRenderer(
        "viewer", glb_data=glb, config=JaxConfig(**cfg))).record_chunks(
            JaxConfig(**cfg), 0, 3)
    port_frames = VideoRecorder(Renderer(
        "viewer", glb_data=glb, config=RenderConfig(**cfg),
        device="cpu")).record_chunks(RenderConfig(**cfg), 0, 3)
    assert len(jax_frames) == len(port_frames) == 3
    for a, b in zip(jax_frames, port_frames):
        assert (a.frame_index, a.timestamp_us, a.key_frame) == \
            (b.frame_index, b.timestamp_us, b.key_frame)
        ia, ib = _decode(a.data).astype(np.int32), decode_png(b.data)
        assert ib.shape == (32, 32, 3) and ib.mean() > 1.0
        assert np.abs(ia - ib).max() <= 1
        assert (ia == ib).mean() >= 0.99
    assert _decode(port_frames[0].data).tolist() != \
        _decode(port_frames[2].data).tolist()


def test_recorded_frames_dark_at_high_spp_as_in_jax():
    """A reference behaviour the port keeps: every recorded frame's tick
    clears the TAA history, and its one present blends at alpha 1/spp, so
    at spp 64 the PNG holds ~1/64 of the accumulated radiance. Both
    recorders give the same dark frame (within 1 code on >= 99%)."""
    cfg = dict(width=48, height=32, max_depth=4, spp=64, fps=30)
    jax_frame = JaxRecorder(JaxRenderer(
        "cornell", config=JaxConfig(**cfg))).record_chunks(
            JaxConfig(**cfg), 0, 1)[0]
    r = Renderer("cornell", config=RenderConfig(**cfg), device="cpu")
    port_frame = VideoRecorder(r).record_chunks(RenderConfig(**cfg), 0, 1)[0]
    a = _decode(jax_frame.data).astype(np.int32)
    b = decode_png(port_frame.data).astype(np.int32)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99
    assert 1 < b.mean() < 16 and r.radiance().mean() > 0.1


# -- image writers and profiling ----------------------------------------------

def _test_image(h, w, seed=0):
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) % 256], -1).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = rs.integers(
        0, 256, size=img[h // 3:h // 2, w // 4:w // 2].shape)
    return img


@pytest.mark.parametrize("shape", [(1, 1), (9, 8), (37, 53), (48, 72)])
def test_png_and_jpeg_decode(shape):
    """PNG decodes to the image (Pillow and the port's decoder). JPEG: its
    mean error against the image is within 5% + 0.1 codes of Pillow's own
    4:4:4 JPEG at quality 85 (the same tables; libjpeg's integer DCT rounds
    otherwise), on a gradient with a noise patch and on pure noise; flat
    images come back within 1 code."""
    img = _test_image(*shape)
    noise = np.random.default_rng(1).integers(0, 256, (*shape, 3),
                                              dtype=np.uint8)
    np.testing.assert_array_equal(_decode(images.png_rgb(img)), img)
    np.testing.assert_array_equal(decode_png(images.png_rgb(img)), img)
    for im in (img, noise):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=85,
                                 subsampling=0)
        ours = _decode(images.jpeg_rgb(im)).astype(np.int32)
        pil = _decode(buf.getvalue()).astype(np.int32)
        assert ours.shape == im.shape
        err, pil_err = np.abs(ours - im).mean(), np.abs(pil - im).mean()
        assert err <= 1.05 * pil_err + 0.1, (err, pil_err)
    for flat in (0, 255, 128):
        img = np.full((16, 24, 3), flat, np.uint8)
        assert np.abs(_decode(images.jpeg_rgb(img)).astype(int)
                      - flat).max() <= 1


def test_jpeg_tables_are_the_standard_ones():
    """The DHT and DQT segments equal Pillow's (libjpeg's) at quality 85."""
    def segments(data):
        out, i = {}, 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            out.setdefault(data[i + 1], b"")
            out[data[i + 1]] += data[i + 4:i + 2 + n]
            i += 2 + n
        return out

    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG",
                                                         quality=85)
    pil = segments(buf.getvalue())
    ours = segments(images.jpeg_rgb(np.zeros((8, 8, 3), np.uint8)))
    assert ours[0xDB] == pil[0xDB]

    def tables(body):
        out, j = {}, 0
        while j < len(body):
            n = sum(body[j + 1:j + 17])
            out[body[j]] = body[j + 1:j + 17 + n]
            j += 17 + n
        return out

    assert tables(ours[0xC4]) == tables(pil[0xC4])


def test_image_format_by_extension():
    assert images.image_format("a/b.PNG") == "png"
    assert images.image_format("x.jpeg") == images.image_format("y.jpg")
    for bad in ("x.bmp", "x", "x.png.gz"):
        with pytest.raises(ValueError):
            images.image_format(bad)


def test_profiling_on_cpu(tmp_path):
    stats = FrameStats(8, 8, 1, 2)
    stats.record(0.01, 1e6)
    stats.record(0.03, 3e6)
    assert stats.ms == pytest.approx(20.0) and stats.fps == pytest.approx(50)
    assert stats.rays_per_sec() == pytest.approx(1e8)
    with tracing():
        with span("add") as first:
            x = torch.ones(4)
            for _ in range(2):
                with span("add.step"):
                    x = x + 1
    mine = [s for s in spans() if s.id >= first.id]
    assert [s.name for s in mine] == ["add.step", "add.step", "add"]
    assert all(s.parent == first.id for s in mine[:2])
    with device_trace(str(tmp_path / "trace")):
        with span("sum"):
            torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events if e.get("cat") == "span"] == ["sum"]
