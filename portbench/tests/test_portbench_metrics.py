"""The window's arithmetic, the device trace's, and the rooflines'."""

from __future__ import annotations

import pytest

from portbench.lib import peaks, spec
from portbench.lib.profile import Op, Trace, busy, gaps, union
from portbench.lib.window import Window, percentile

BENCH = spec.Spec()


def _window(ends, t_open=10.0, rays=0.0, setup=3.0):
    return Window(setup_s=setup, t_open=t_open, ends=ends, rays=rays,
                  pixels=720 * 480, tris=36, light_rows=2)


def _read(name, *args):
    kind = "end_to_end" if len(args) == 1 else "per_layer"
    return BENCH.reader(kind, name).read(*args)


def test_rate_and_mean_are_over_the_whole_window_with_a_stall():
    # 99 frames of 2 ms, then one stall of 100 ms.
    ends, t = [], 10.0
    for k in range(100):
        t += 0.1 if k == 50 else 0.002
        ends.append(t)
    w = _window(ends, rays=100 * 2.5e6)
    window_s = 99 * 0.002 + 0.1
    assert w.window_s == pytest.approx(window_s)
    assert _read("frame_ms", w) == pytest.approx(1e3 * window_s / 100)
    assert _read("mrays_per_s", w) == pytest.approx(2.5e8 / window_s / 1e6)
    assert _read("setup_s", w) == 3.0


def test_p95_is_over_every_frame():
    # 90 fast frames and 10 slow ones: the p95 lies among the slow.
    ends, t = [], 0.0
    for k in range(100):
        t += 0.010 if k % 10 == 9 else 0.002
        ends.append(t)
    w = _window(ends, t_open=0.0)
    assert _read("frame_ms_p95", w) == pytest.approx(10.0)
    assert percentile(range(101), 95) == pytest.approx(95.0)
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)


@pytest.mark.parametrize("n,k", [(720 * 480, 16384), (48, 7), (10, 10),
                                 (10, 40)])
def test_checked_pixels_are_one_in_each_equal_run(n, k):
    import random

    from portbench.lib import drivers
    cfg = dict(width=n, height=1, check_pixels=k)
    px = drivers.pixels(random.Random(5), cfg, "cpu").tolist()
    again = drivers.pixels(random.Random(5), cfg, "cpu").tolist()
    assert px == again and px == sorted(set(px))
    if k >= n:
        assert px == list(range(n))
    else:
        assert len(px) == k
        assert all(i * n // k <= p < (i + 1) * n // k
                   for i, p in enumerate(px))


def test_split_metric_reads_as_its_quantity():
    w = _window([10.5, 11.0, 13.0], rays=6e6)
    assert _read("mrays_per_s.record", w) == _read("mrays_per_s", w)


def test_frame_times_fill_the_window():
    w = _window([10.5, 11.0, 13.0])
    assert w.frame_s() == pytest.approx([0.5, 0.5, 2.0])
    assert sum(w.frame_s()) == pytest.approx(w.window_s)


def _trace(ops, t0=0.0, t1=10.0, spans=(), **kw):
    args = dict(frames=1, presents=1, rays=0.0, launches={})
    args.update(kw)
    return Trace(ops=[Op(*o) for o in ops], spans=list(spans), t0=t0, t1=t1,
                 **args)


def test_idle_share_over_overlapping_intervals():
    ops = [("a", 1.0, 3.0, 0.5, "render_frame"),
           ("b", 2.0, 4.0, 0.6, "render_frame"),   # overlaps a
           ("c", 2.5, 3.5, 0.7, "present"),        # inside both
           ("d", 6.0, 7.0, 5.0, "present"),
           ("e", 9.5, 12.0, 9.0, "present")]       # runs past the stretch
    t = _trace(ops)
    assert union([(1, 3), (2, 4), (6, 7)]) == [(1, 4), (6, 7)]
    assert t.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    assert _read("idle_share.interactive", t, None) == pytest.approx(55.0)
    assert _read("idle_share.record", t, None) == pytest.approx(55.0)
    assert spec.reader_path("per_layer", "idle_share.record") == \
        spec.reader_path("per_layer", "idle_share.interactive")
    assert gaps([(1, 3), (6, 7)], 0, 10) == [(0, 1), (3, 6), (7, 10)]
    assert busy([], 0, 1) == 0


def test_present_ms_attributes_by_launching_span():
    ops = [("k1", 1.0, 1.002, 0.5, "render_frame"),
           ("k2", 1.002, 1.003, 0.9, "present"),
           ("copy", 1.003, 1.0035, 0.95, "present"),
           ("k3", 1.1, 1.102, 1.05, "render_frame")]
    t = _trace(ops, presents=2)
    assert _read("present_ms", t, None) == pytest.approx(0.75)
    assert _read("present_ms", _trace([], presents=0), None) is None


def test_record_gap_reads_idle_between_frames():
    ops = [("s1", 1.0, 1.1, 0.9, "render_frame"),
           ("s2", 1.1, 1.2, 0.95, "render_frame"),
           ("p", 1.25, 1.30, 1.21, "present"),      # busy inside the gap
           ("s3", 1.6, 1.7, 1.55, "render_frame")]
    spans = [("present", 1.21, 1.31), ("render_frame", 0.9, 0.92)]
    t = _trace(ops, spans=spans)
    # idle between 1.2 and 1.6 less the present's 0.05 s
    assert _read("record.gap_ms", t, None) == pytest.approx(350.0)
    assert _read("record.gap_ms", _trace(ops[:2], spans=spans), None) is None


def test_breakdown_names_gaps_by_span():
    ops = [("k", 1.0, 2.0, 0.5, "render_frame"),
           ("k", 5.0, 6.0, 4.5, "present")]
    spans = [("stretch", 0.0, 10.0), ("present", 3.0, 4.0)]
    t = _trace(ops, spans=spans)
    b = t.breakdown()
    assert b["device_ops"] == [["k", pytest.approx(2.0)]]
    assert b["idle_gaps"][0] == ["outside spans", pytest.approx(4.0)]
    assert ["present", pytest.approx(3.0)] in b["idle_gaps"]


def test_narrow_ms_reads_only_with_job_sweeps():
    ops = [("void job_sweep_kernel(float const*)", 0, 0.010, 0, "frame"),
           ("void cluster_cull_kernel<4>(float4 const*)", 0, 0.002, 0, ""),
           ("DeviceRadixSortOnesweepKernel", 0, 0.001, 0, ""),
           ("void shade_rows_kernel<false>()", 0, 0.5, 0, "")]
    t = _trace(ops, frames=2, launches={"job_sweep": 1})
    assert _read("narrow_ms", t, None) == pytest.approx(6.5)
    assert _read("narrow_ms", _trace(ops, frames=2), None) is None


# -- rooflines ---------------------------------------------------------------

def test_shade_roofline_reproduces_chip_smoke_at_512():
    """At PERF.md's shade shape (262,144 lanes, cornell's 8 light rows),
    with every lane live, the frozen arithmetic gives chip_smoke's bytes,
    operations and bound."""
    import chip_smoke
    import torch
    R, light_rows = 262144, 8

    class Tables:
        light_rows = torch.zeros(8, 40)

    want_ms, _ = chip_smoke.bound(chip_smoke.shade_bytes(Tables, R),
                                  R * chip_smoke.SHADE_OPS)
    # one launch, one frame of R primaries, and 2R bounce rays: R live
    t = _trace([], frames=1, rays=3.0 * R, launches={"shade_rows": 1})
    w = _window([1.0])
    w.pixels, w.light_rows = R, light_rows
    got = spec.roofline("shade_rows").least_s(t, w)
    assert 1e3 * got == pytest.approx(want_ms, rel=1e-12)
    assert chip_smoke.SHADE_OPS == spec.roofline("shade_rows").SHADE_OPS


def test_sweep_roofline_reproduces_chip_smoke_ops_and_lane_bytes():
    """chip_smoke's sweep bound at cornell 512² counts every lane of the
    fused stack and the shade table; with every lane a primary and live,
    the frozen arithmetic gives its operations, and its bytes less the
    shade-table read and the dead lanes' outputs."""
    import chip_smoke
    R, tris = 262144, 36
    mod = spec.roofline("dense_sweep")
    assert mod.SWEEP_OPS == chip_smoke.SWEEP_OPS
    t = _trace([], frames=1, rays=float(R), launches={"dense_sweep": 1})
    w = _window([1.0])
    w.pixels, w.tris = R, tris
    ops = R * tris * chip_smoke.SWEEP_OPS
    nbytes = tris * 16 * 5 * 4 + R * (32 + 8) + R * 160
    assert mod.least_s(t, w) == pytest.approx(peaks.least_s(nbytes, ops))
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.F32_OPS_PER_S == chip_smoke.F32_OPS_PER_S


@pytest.mark.parametrize("kernel", ["dense_sweep", "shade_rows"])
def test_roofline_never_counts_dead_lanes(kernel):
    """The bound follows the rays the frames traced and the launches, never
    the width of the ray stacks (2R lanes a bounce, most of them dead late
    in a frame): the same rays give the same bound whatever the pixels
    beyond the primaries, and the shade kernel's live lanes only shrink as
    more of the rays are primaries."""
    mod = spec.roofline(kernel)
    t = _trace([], frames=1, rays=5e5, launches={kernel: 11})
    small, big = _window([1.0]), _window([1.0])
    small.pixels, big.pixels = 100_000, 200_000
    if kernel == "shade_rows":
        assert mod.least_s(t, big) <= mod.least_s(t, small)
        # Every lane died at its primary hit: no live shade lane.
        t0 = _trace([], frames=1, rays=200_000.0, launches={kernel: 11})
        assert mod.least_s(t0, big) == pytest.approx(
            11 * big.light_rows * 160 / peaks.HBM_BYTES_PER_S)
    else:
        # All 5e5 rays tested: 100k primaries against every triangle,
        # 4e5 bounce rays against one; no lane beyond the rays counted.
        ops = mod.SWEEP_OPS * (100_000 * 36 + 400_000)
        nbytes = 11 * 36 * mod.FEATURE_BYTES + 5e5 * mod.RAY_BYTES \
            + 100_000 * mod.ROW_BYTES
        assert mod.least_s(t, small) == pytest.approx(
            peaks.least_s(nbytes, ops))


def test_shade_live_lanes_bound_below_the_true_count():
    """Simulated bounces: each live lane casts a NEE ray, an extension ray,
    or both; the roofline's live lanes never exceed the true ones."""
    import random
    rnd = random.Random(5)
    R = 1000
    live, rays = 0, R
    alive = R
    for _ in range(10):
        live += alive
        casts = [rnd.choice(((1, 0), (0, 1), (1, 1))) for _ in range(alive)]
        rays += sum(a + b for a, b in casts)
        alive = sum(b for _, b in casts) * 3 // 4
    assert (rays - R) / 2 <= live
