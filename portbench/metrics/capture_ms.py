"""Host ms the process spent capturing the frame steps as CUDA graphs:
the program's process-wide `capture_ms` counter (`utils/profiling.count`,
added by `CapturedSteps`), read once the run is over. Every step key is
captured in set-up, so this is set-up's share. None where the program
has no such counter or captured nothing."""


def read(trace, window):
    try:
        from webgpu_raytracer_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get("capture_ms")
