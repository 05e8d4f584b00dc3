"""The `cornell1080-sample4` cell on the CPU: `loops/sharded.py` end to end
through `run.run_cell` in a 4-rank gloo world at a tiny size, a rank that
raises mid-window, and the cell's per-layer readers (`all_reduce_ms`, the
BVH walk and shade rooflines, `host_idle_ms.sharded`) on synthetic traces
and on traces with nothing to read."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from portbench.lib import peaks, spec
from portbench.lib.profile import Op, Trace
from portbench.lib.window import Window
from portbench.loops.sharded import JOIN_S
from portbench.loops.sharded import rank_loop as _rank_loop
from portbench.run import run_cell
from webgpu_raytracer_tpu_torch.utils.profiling import Span

BENCH = spec.Spec()
CELL = "cornell1080-sample4"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# cornell at 16 x 8, depth 3, still 4 ranks of one sample a step; blocks of
# 4 steps and the checked steps among the first 4, so a window of a few
# steps holds them.
TINY = dict(width=16, height=8, max_depth=3, block=4, check_within=4,
            check_frames=2, frames_before_window=1)
SLACK_S = 30.0
MAIN = threading.main_thread().native_id


def test_sharded_loop_is_correct_on_the_cpu():
    res = run_cell(BENCH, CELL, 2 ** 31 + 977, 0.5, False, device="cpu",
                   overrides=TINY)
    print(f"{CELL} on the CPU: {json.dumps(res['checks'])}")
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert set(res["checks"]) == set(BENCH.limits(CELL))
    assert res["attempted"] >= TINY["check_within"]
    assert res["checked"] == TINY["check_frames"] * 16 * 8
    assert set(res["metrics"]) == {"mrays_per_s", "setup_s"}
    assert res["metrics"]["mrays_per_s"]["value"] > 0


def failing_rank(rank, n, cfg, *args):
    """The loop's rank; the last rank's third step in the window raises.
    Each rank writes its pid into `cfg["pid_dir"]` first."""
    from webgpu_raytracer_tpu_torch.parallel import sharding

    with open(os.path.join(cfg["pid_dir"], f"rank{rank}"), "w") as f:
        f.write(str(os.getpid()))
    if rank == n - 1:
        real, calls = sharding.ShardedStep.__call__, []

        def call(self, *a, **kw):
            calls.append(1)
            if len(calls) == cfg["frames_before_window"] + 3:
                raise RuntimeError("a rank that fails mid-window")
            return real(self, *a, **kw)
        sharding.ShardedStep.__call__ = call
    return _rank_loop(rank, n, cfg, *args)


RUN = """
    import json
    from portbench.lib import spec
    from portbench.loops import sharded
    from portbench.run import run_cell
    from portbench.tests import test_portbench_sample4 as t
    sharded.rank_loop = t.failing_rank
    res = run_cell(spec.Spec(), t.CELL, 5, 60.0, False, device="cpu",
                   overrides=dict(t.TINY, pid_dir={pid_dir!r}))
    print(json.dumps({{"correct": res["correct"]}}))
"""


def test_a_rank_that_raises_mid_window_fails_the_run(tmp_path):
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(RUN.format(
            pid_dir=str(tmp_path)))], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=JOIN_S + 2 * SLACK_S)
    took = time.monotonic() - t0
    assert out.returncode != 0, out.stdout + out.stderr[-2000:]
    assert took < JOIN_S + SLACK_S
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    pids = [int(p.read_text()) for p in tmp_path.iterdir()]
    assert len(pids) == 4, out.stderr[-2000:]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# -- the readers ---------------------------------------------------------------

NCCL = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL"
        "(ncclDevKernelArgsStorage<4096ul>)")
CLOSEST = "void bvh_walk_kernel<false>(float const*, int)"
SHADOW = "void bvh_walk_kernel<true>(float const*, int)"
SHADE = "void (anonymous namespace)::bvh_shade_kernel(ShadeArgs)"
READERS = ("all_reduce_ms", "bvh_walk_roofline", "bvh_shade_roofline",
           "host_idle_ms.sharded")


def _read(name, trace, window):
    return BENCH.reader("per_layer", name).read(trace, window)


def _trace(ops=(), spans=(), frames=2, rays=0.0, t1=0.05):
    return Trace(ops=[Op(*o) for o in ops],
                 spans=[("stretch", 0.0, t1)] + list(spans), t0=0.0, t1=t1,
                 frames=frames, presents=0, rays=rays, launches={})


def _window(pixels):
    return Window(setup_s=1.0, t_open=0.0, ends=[1.0], rays=0.0,
                  pixels=pixels, tris=36, light_rows=2)


def test_the_cell_reports_its_readers():
    """Its own four, and the set-up's capture time, which rank 0's
    `CapturedSteps` counts as every other cell's does."""
    names = {m["name"] for m in BENCH.metrics("per_layer", CELL)}
    assert names == set(READERS) | {"capture_ms"}
    assert {m["name"] for m in BENCH.metrics("end_to_end", CELL)} == {
        "mrays_per_s", "setup_s"}
    assert BENCH.workload(CELL)["chips"] == 4


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_with_nothing_to_read(name):
    """No device operation and no program span: nothing to read, as on a
    version of the program without these kernels or spans."""
    assert _read(name, _trace(spans=[("sharded.step", 0.01, 0.02)]),
                 _window(100)) is None


def test_all_reduce_ms_on_a_synthetic_trace():
    """Two steps: each one NCCL kernel of 0.4 ms, beside a walk the pattern
    does not take; 0.4 ms a step."""
    ops = [(NCCL, 0.010, 0.0104, 0.001, "sharded.step"),
           (CLOSEST, 0.0104, 0.0110, 0.001, "sharded.step"),
           (NCCL, 0.020, 0.0204, 0.011, "sharded.step")]
    assert _read("all_reduce_ms", _trace(ops), _window(100)) == \
        pytest.approx(0.4)


def test_bvh_rooflines_on_a_synthetic_trace():
    """One step of 1,000 pixels and 5,000 rays: the walk's bound is the
    rays' 25 bytes; the shade's live lanes are (5,000 - 1,000) / 2, each
    206 bytes and 650 separately rounded operations. Both shares at or
    under 100% on kernels that take the bound's time or longer."""
    walk, shade = spec.roofline("bvh_walk"), spec.roofline("bvh_shade")
    t = _trace([(CLOSEST, 0.0, 2e-8, None, ""),
                (SHADOW, 1e-6, 1e-6 + 2e-8, None, ""),
                (SHADE, 2e-6, 2e-6 + 2e-7, None, "")], frames=1,
               rays=5000.0)
    w = _window(1000)
    walk_s = 5000 * 25 / peaks.HBM_BYTES_PER_S
    assert walk.least_s(t, w) == pytest.approx(walk_s)
    live = 2000
    shade_s = max(live * 206 / peaks.HBM_BYTES_PER_S,
                  live * 650 / (peaks.F32_OPS_PER_S / 2))
    assert shade.least_s(t, w) == pytest.approx(shade_s)
    assert _read("bvh_walk_roofline", t, w) == pytest.approx(
        100 * walk_s / 4e-8)
    assert _read("bvh_shade_roofline", t, w) == pytest.approx(
        100 * shade_s / 2e-7)
    assert 0 < _read("bvh_walk_roofline", t, w) <= 100
    assert 0 < _read("bvh_shade_roofline", t, w) <= 100


def test_bvh_rooflines_follow_chip_smoke():
    """The frozen constants are chip_smoke.py's: its BVH shade operations
    and its per-lane bytes without the two masks."""
    import chip_smoke
    shade = spec.roofline("bvh_shade")
    assert shade.BVH_SHADE_OPS == chip_smoke.BVH_SHADE_OPS
    assert shade.LANE_IN + shade.LANE_OUT == 206
    assert peaks.F32_OPS_PER_S / 2 == chip_smoke.F32_ROUNDED_OPS_PER_S


def _span(name, start_s, end_s, offset, delay=0):
    return Span(name, 0, 0, None, MAIN, round(start_s * 1e9) - offset + delay,
                round(end_s * 1e9) - offset)


def test_host_idle_ms_sharded_on_a_synthetic_trace():
    """Four steps of 10 ms: the device idles 1 ms before each step's graph
    inside the program's `sharded.inputs`, and 0.5 ms after it outside
    every program span (the harness's synchronise); the program's spans
    open 4-6 us after the harness's. 1 ms a step."""
    reader = spec.load_module(spec.reader_path("per_layer",
                                               "host_idle_ms.sharded"))
    offset = -1_790_000_000_000_000_000 + 4321
    theirs, ours, ops = [], [], []
    for k, delay in enumerate([4000, 5000, 6000, 5000]):
        s = 0.001 + 0.0105 * k
        theirs.append(("sharded.step", s, s + 0.010))
        ours += [_span("sharded.step", s, s + 0.010, offset, delay),
                 _span("sharded.inputs", s, s + 0.001, offset, delay)]
        ops.append(("graph", s + 0.001, s + 0.010, s, "sharded.step"))
    t = _trace(ops, theirs, frames=4, t1=0.043)
    prog = reader.align(t, ours)
    assert prog is not None and prog.offset_ns == offset - 5000
    split = prog.idle_by_span(t)
    # Mapped by the median offset, each `sharded.inputs` ends 5 us early:
    # that idle falls to its `sharded.step`.
    assert split["sharded.inputs"] == pytest.approx(4 * 0.000995, abs=1e-9)
    assert split["sharded.step"] == pytest.approx(4 * 5e-6, abs=1e-9)
    # Through `read`, the program's own record holds no such spans here.
    assert _read("host_idle_ms.sharded", t, None) is None
    got = 1e3 * (sum(split.values()) - split[""]) / t.frames
    assert got == pytest.approx(1.0, abs=1e-4)
    # Pairs that spread past SPREAD_S (200 us) do not align.
    bad = [s._replace(start_ns=s.start_ns + 400_000 * (i % 4 == 0))
           for i, s in enumerate(ours)]
    assert reader.align(t, bad) is None
