"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.Spec()
DATA = BENCH.data


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(DATA["command"]) <= 32
    assert all(_line(w) for w in DATA["command"])
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    script = DATA["command"][1]
    assert any(script.startswith(p + "/") for p in DATA["paths"])
    assert isinstance(DATA["run_seconds"], int)
    assert 1 <= DATA["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 65536


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and len(entry["reduced"]) <= 16
    assert entry["file"].startswith(tuple(p + "/" for p in DATA["paths"]))
    cfg = BENCH.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in DATA["workloads"])
    files = [c["file"] for c in DATA["configs"]]
    assert files.count(entry["file"]) == 1


@pytest.mark.parametrize("cell", DATA["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    traffic = BENCH.traffic(cell["traffic"])
    assert NAME.match(traffic["loop"])
    assert callable(BENCH.loop(cell["traffic"]).run)
    limits = BENCH.limits(cell["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in BENCH.metrics("end_to_end", cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.metrics("per_layer", cell["name"])
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell["name"])


def test_unique_names_and_pairs():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in DATA[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert four <= max(1, len(DATA["workloads"]) // 4)


@pytest.mark.parametrize("m", DATA["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert callable(BENCH.reader("end_to_end", m["name"]).read)


@pytest.mark.parametrize("m", DATA["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _line(m["layer"])
    assert m["moves"] in {e["name"] for e in DATA["end_to_end"]}
    cells = {w["name"] for w in DATA["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    quantity = m["name"].split(".")[0]
    if m["unit"] == "%" and "roofline" in m["name"]:
        assert quantity.endswith("_roofline")
        kernel = quantity[:-len("_roofline")]
        assert callable(spec.roofline(kernel).least_s)
        assert kernel in spec.kernel_patterns()
    assert callable(BENCH.reader("per_layer", m["name"]).read)


def test_split_metrics_share_their_quantity():
    """A metric split by its cells (`<quantity>.<cells>`) keeps the
    quantity's unit and direction, moves a metric that each of its cells
    reports, and is read by the quantity's file unless it has its own."""
    every = DATA["end_to_end"] + DATA["per_layer"]
    for m in every:
        head = m["name"].split(".")[0]
        for o in every:
            if o is not m and o["name"].split(".")[0] == head:
                assert (o["unit"], o["better"]) == (m["unit"], m["better"])
        kind = "end_to_end" if m in DATA["end_to_end"] else "per_layer"
        path = spec.reader_path(kind, m["name"])
        assert os.path.basename(path) in (m["name"] + ".py", head + ".py")
        assert os.path.exists(path)


def test_layers_named_alike():
    """Metrics of one layer give the same `layer`, letter for letter."""
    layers = {m["layer"] for m in DATA["per_layer"]}
    lowered = {}
    for layer in layers:
        lowered.setdefault(layer.lower().strip(), set()).add(layer)
    assert all(len(v) == 1 for v in lowered.values())


def test_files_named_from_name_characters():
    for dirpath, _, files in os.walk(spec.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_kernel_patterns_cover_the_counters():
    """Every launch counter of the program has its kernels' device name."""
    from webgpu_raytracer_tpu_torch import kernels
    assert set(kernels.launches) <= set(spec.kernel_patterns())


def test_benchmark_json_is_json():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        json.load(f)
