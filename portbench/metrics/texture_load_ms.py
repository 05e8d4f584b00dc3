"""Host ms the process spent on a scene's textures at set-up: the
program's process-wide `texture_load_ms` counter (`utils/profiling.count`,
added by `Renderer` around the layers' decode, the quad pyramid and its
upload), read once the run is over. None where the program has no such
counter or the scene binds no texture."""


def read(trace, window):
    try:
        from webgpu_raytracer_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get("texture_load_ms")
