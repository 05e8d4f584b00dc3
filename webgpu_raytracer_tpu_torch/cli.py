"""Command-line entry point: the app-shell analogue (reference src/main.ts
+ UI).

The port of the JAX package's `cli.py`, run as

    python -m webgpu_raytracer_tpu_torch.cli <subcommand> [flags]

with the same subcommands, flags and defaults, and one flag more:
`--device` (default "cuda"; the port's entry points run on the card unless
asked for the CPU). `render --output` writes PNG, or JPEG for a `.jpg` /
`.jpeg` path, without Pillow; any other extension raises.

Subcommands:
  render   progressive render of a preset/model to PNG (the rAF loop analog)
  record   offline animation render to video / frame dir (VideoRecorder)
  serve    start the render-farm coordinator (DistributedHost + server)
  worker   join a render farm as a worker (DistributedWorker)
  info     print scene statistics (world-bridge getStats analogue)

A 1 Hz stats line (fps / ms / accumulated frames, reference main.ts:175-180)
prints during interactive rendering.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import RenderConfig
from .utils.images import encode_image, image_format
from .utils.profiling import synchronize


def _load_model(path: str | None):
    obj_source = None
    glb_data = None
    file_type = None
    if path:
        if path.endswith(".obj"):
            with open(path) as f:
                obj_source = f.read()
            file_type = "obj"
        elif path.endswith((".glb", ".vrm")):
            with open(path, "rb") as f:
                glb_data = f.read()
            file_type = "glb"
        else:
            raise SystemExit(f"unsupported model type: {path}")
    return obj_source, glb_data, file_type


def _make_renderer(args):
    from .render.renderer import Renderer

    obj_source, glb_data, _ = _load_model(getattr(args, "model", None))
    cfg = RenderConfig(
        width=args.width, height=args.height, max_depth=args.depth,
        shader_spp=args.shader_spp, scene_name=args.scene,
        fps=getattr(args, "fps", 30),
        duration=getattr(args, "duration", 3.0),
        spp=getattr(args, "spp", 64),
        anim_index=getattr(args, "anim", 0),
        update_interval=getattr(args, "update_interval", 4),
    )
    r = Renderer(args.scene, obj_source=obj_source, glb_data=glb_data,
                 config=cfg, device=args.device)
    anim_glb = getattr(args, "anim_glb", None)
    if anim_glb:
        with open(anim_glb, "rb") as f:
            if not r.load_animation_glb(f.read()):
                raise SystemExit(f"no animations found in {anim_glb}")
        r.set_animation(cfg.anim_index)
        names = [r.world.animation_name(i)
                 for i in range(r.world.animation_count())]
        print(f"[anim] loaded clips from {anim_glb}: {names}")
    return r


def cmd_render(args):
    from .utils.profiling import FrameStats

    image_format(args.output)  # an unknown format fails before rendering
    r = _make_renderer(args)
    preview = None
    if getattr(args, "preview", None) is not None:
        from .render.preview import PreviewServer

        preview = PreviewServer(port=args.preview)
        print(f"[render] live preview: http://127.0.0.1:{preview.port}/")
    use_gbuffer = getattr(args, "gbuffer", False)
    if use_gbuffer and r.backend != "dense":
        print("[render] --gbuffer requires the dense backend; ignored")
        use_gbuffer = False
    print(f"[render] scene={args.scene} {args.width}x{args.height} "
          f"depth={args.depth} backend={r.backend}"
          + (" gbuffer" if use_gbuffer else ""))
    t_start = time.perf_counter()
    last_stats = t_start
    stats = FrameStats(args.width, args.height, args.shader_spp, args.depth)
    animate = getattr(args, "animate", False)
    last_pub = 0.0  # last preview publish time (~10 Hz cap)
    interval = max(1, r.config.update_interval)
    tick_fps = max(1, getattr(args, "fps", 30))
    pending = None  # in-flight async scene update (main.ts renderFrame loop)
    for i in range(args.frames):
        t0 = time.perf_counter()
        if animate and i % interval == 0 and pending is None:
            # Kick the native scene tick asynchronously; it overlaps the
            # device work below (reference main.ts:119-131).
            pending = r.bridge.update_async(i / tick_fps)
        if pending is not None and pending.done():
            # hasNewData: re-upload dirty buffers + reset accumulation
            # (reference main.ts:132-166).
            r.bridge.wait()
            r.reupload_scene(reset=True)
            pending = None
        r.render_frame(use_gbuffer=use_gbuffer)
        if animate or preview is not None:
            # Advance the TAA history every tick like the rAF loop (present
            # is part of the frame contract once anything displays frames).
            r.present()
        synchronize(r.device)
        if preview is not None:
            now_p = time.perf_counter()
            if i == args.frames - 1 or now_p - last_pub >= 0.1:  # ~10 Hz
                last_pub = now_p
                preview.publish(r.capture_frame(),
                                stats=f"{stats.line()} "
                                      f"frames={r.frame_count}")
        # Exact traced-ray count for this frame (device scalar from the
        # render step) — the stats line reports MEASURED Mrays/s.
        stats.record(time.perf_counter() - t0, float(r.last_rays))
        now = time.perf_counter()
        if now - last_stats >= 1.0:  # 1 Hz stats overlay analogue
            print(f"[stats] {stats.line()} frames={r.frame_count}")
            last_stats = now
    if pending is not None:
        r.bridge.wait()
    img = r.present()
    with open(args.output, "wb") as f:
        f.write(encode_image(img, args.output))
    total = time.perf_counter() - t_start
    print(f"[stats] {stats.line()} frames={r.frame_count}")
    print(f"[render] {args.frames} frames in {total:.2f}s -> {args.output}")
    if preview is not None:
        preview.close()


def cmd_record(args):
    from .render.recorder import VideoRecorder

    r = _make_renderer(args)
    rec = VideoRecorder(r)
    cfg = r.config

    def progress(done, total):
        print(f"[record] frame {done}/{total}")

    result = rec.record(cfg, output=args.output, on_progress=progress)
    print(f"[record] done in {result.wall_time_s:.1f}s -> "
          f"{result.output_path} ({len(result.frames)} frames)")


def cmd_serve(args):
    from .parallel.cluster import Coordinator
    from .render.recorder import mux_frames

    coord = Coordinator(secret=args.secret, host=args.host, port=args.port)
    print(f"[serve] coordinator on {args.host}:{coord.port}")
    if args.admin_port is not None:
        ap = coord.start_admin(host=args.host, port=args.admin_port,
                               password=args.admin_password)
        print(f"[serve] admin console: http://{args.host}:{ap}"
              f"/admin/api/status")

    obj_source, glb_data, file_type = _load_model(args.model)
    payload = b""
    if obj_source:
        payload = obj_source.encode()
    elif glb_data:
        payload = glb_data
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, shader_spp=args.shader_spp,
                       fps=args.fps, duration=args.duration, spp=args.spp,
                       scene_name=args.scene, job_batch=args.job_batch,
                       anim_index=args.anim, file_type=file_type)
    coord.set_scene(cfg, args.scene, payload, file_type)
    total_frames = int(cfg.fps * cfg.duration)
    print(f"[serve] waiting for workers; {total_frames} frames queued "
          f"in jobs of {cfg.job_batch}")
    coord.start_render(total_frames, cfg.job_batch)
    try:
        while not coord.wait(2.0):
            st = coord.admin_status()
            print(f"[serve] queue={st['queue']} results={st['results']}/"
                  f"{st['expected']} workers={len(st['workers'])}")
    except KeyboardInterrupt:
        coord.stop_render()
        coord.close()
        return
    frames = coord.collect_frames()
    out = mux_frames(frames, cfg.fps, args.output)
    print(f"[serve] complete -> {out}")
    coord.close()


def cmd_worker(args):
    from .parallel.cluster import WorkerClient

    # One WorkerClient across reconnects: its session_id/session_token pair
    # and buffered unsent results survive the connection drop, so the
    # coordinator resumes the worker's identity and in-flight job (reference
    # sessionStorage persistence, SignalingClient.ts:52-59, server.ts:240-289).
    w = WorkerClient(args.host, args.port, secret=args.secret,
                     device=args.device)
    while True:
        try:
            w.connect()
            print(f"[worker] connected as worker {w.worker_id}")
            w.run()
            print("[worker] connection closed")
        except (ConnectionError, OSError) as e:
            print(f"[worker] connect failed: {e}")
        if not args.reconnect:
            return
        time.sleep(2.0)  # host-side retry cadence analogue


def cmd_info(args):
    from .models.native import NativeWorld

    obj_source, glb_data, _ = _load_model(getattr(args, "model", None))
    w = NativeWorld(args.scene, obj_source, glb_data)
    topo = w.topology().size // 20
    print(f"scene: {args.scene}")
    print(f"  vertices:   {w.vertices().size // 4}")
    print(f"  triangles:  {topo}")
    print(f"  instances:  {w.instances().size // 36}")
    print(f"  tlas nodes: {w.tlas().size // 8}")
    print(f"  blas nodes: {w.blas().size // 8}")
    print(f"  lights:     {w.lights().size // 2}")
    print(f"  textures:   {w.texture_count()}")
    print(f"  animations: {w.animation_count()} "
          f"{[w.animation_name(i) for i in range(w.animation_count())]}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="webgpu_raytracer_tpu_torch",
        description="progressive path tracer on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to render on (cuda, cuda:N or "
                             "cpu)")

    def common(sp, record=False):
        sp.add_argument("--scene", default="cornell",
                        choices=["cornell", "spheres", "mixed", "special",
                                 "mesh", "viewer"])
        sp.add_argument("--model", help=".obj/.glb/.vrm file")
        sp.add_argument("--width", type=int, default=720)
        sp.add_argument("--height", type=int, default=480)
        sp.add_argument("--depth", type=int, default=10)
        sp.add_argument("--shader-spp", type=int, default=1, dest="shader_spp")
        sp.add_argument("--anim", type=int, default=0,
                        help="animation clip index (UI anim select analogue)")
        sp.add_argument("--anim-glb", dest="anim_glb",
                        help="merge animation clips from another .glb/.vrm")
        if record:
            sp.add_argument("--fps", type=int, default=30)
            sp.add_argument("--duration", type=float, default=3.0)
            sp.add_argument("--spp", type=int, default=64)

    sp = sub.add_parser("render", help="progressive still render")
    common(sp)
    device(sp)
    sp.add_argument("--frames", type=int, default=64,
                    help="progressive frames to accumulate")
    sp.add_argument("--animate", action="store_true",
                    help="tick the scene every update-interval frames "
                         "(the reference's interactive rAF loop)")
    sp.add_argument("--gbuffer", action="store_true",
                    help="seed bounce 0 from the rasterizer-analogue "
                         "G-buffer pass (reference Rasterizer.wgsl hand-off;"
                         " dense backend only)")
    sp.add_argument("--fps", type=int, default=30,
                    help="scene-time ticks per second when animating")
    sp.add_argument("--update-interval", type=int, default=4,
                    dest="update_interval",
                    help="frames between scene ticks (config.ts default 4)")
    sp.add_argument("--output", default="render.png")
    sp.add_argument("--preview", type=int, nargs="?", const=0, default=None,
                    help="serve a live MJPEG preview on this port (0 = "
                         "auto); the reference's live canvas analogue")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("record", help="offline animation render")
    common(sp, record=True)
    device(sp)
    sp.add_argument("--output", default="render_out")
    sp.set_defaults(fn=cmd_record)

    sp = sub.add_parser("serve", help="render-farm coordinator")
    common(sp, record=True)
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--port", type=int, default=8765)
    sp.add_argument("--secret", default="")
    sp.add_argument("--job-batch", type=int, default=20, dest="job_batch")
    sp.add_argument("--output", default="farm_out")
    sp.add_argument("--admin-port", type=int, default=None, dest="admin_port")
    sp.add_argument("--admin-password", default="", dest="admin_password")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("worker", help="render-farm worker")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8765)
    sp.add_argument("--secret", default="")
    sp.add_argument("--reconnect", action="store_true")
    device(sp)
    sp.set_defaults(fn=cmd_worker)

    sp = sub.add_parser("info", help="scene statistics")
    sp.add_argument("--scene", default="cornell")
    sp.add_argument("--model")
    sp.set_defaults(fn=cmd_info)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
