"""`BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json`      the configuration as it is run (the entry's
                               `file`);
- `scenes/<model>.py`          `glb()`: the bytes of the GLB model that a
                               configuration's optional `"model"` names;
- `traffic/<traffic>.json`     a traffic mix: the loop it runs (`"loop"`)
                               and the loop's parameters;
- `loops/<loop>.py`            `run(...)` of one kind of user's loop, found
                               by the traffic file's `"loop"`;
- `limits/<workload>.json`     each number the output check compares, with
                               its limit;
- `endtoend/<metric>.py`       `read(window)` of an end-to-end metric;
- `metrics/<metric>.py`        `read(trace, window)` of a per-layer metric.
                               A metric split by the cells it serves
                               (`<quantity>.<cells>`, such as
                               `idle_share.record`) is read by the file of
                               its whole name, or else by `<quantity>.py`;
- `roofline/<kernel>.py`       the least time of a kernel's frame work;
- `kernels/<counter>.json`     the device names of a launch counter's kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """Import one file by path (its name may hold dots)."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """One benchmark description and the lookups of its files."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(HERE, "traffic", name + ".json"))

    def limits(self, workload: str) -> dict:
        return load_json(os.path.join(HERE, "limits", workload + ".json"))

    def metrics(self, kind: str, workload: str) -> list[dict]:
        """The `end_to_end` or `per_layer` entries that `workload` reports."""
        return [m for m in self.data[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, kind: str, name: str) -> ModuleType:
        return load_module(reader_path(kind, name))

    def loop(self, traffic: str) -> ModuleType:
        """The loop module that a traffic mix runs."""
        return load_module(os.path.join(HERE, "loops",
                                        self.traffic(traffic)["loop"] + ".py"))


def reader_path(kind: str, name: str) -> str:
    """The file that reads a metric: `<name>.py`, or for a metric split by
    cells `<quantity>.py` (the name up to its first dot)."""
    folder = os.path.join(HERE, "endtoend" if kind == "end_to_end"
                          else "metrics")
    whole = os.path.join(folder, name + ".py")
    if os.path.exists(whole) or "." not in name:
        return whole
    return os.path.join(folder, name.split(".")[0] + ".py")


def scene(model: str) -> ModuleType:
    """The file that writes a configuration's model (`glb()`)."""
    return load_module(os.path.join(HERE, "scenes", model + ".py"))


def roofline(kernel: str) -> ModuleType:
    return load_module(os.path.join(HERE, "roofline", kernel + ".py"))


def kernel_patterns() -> dict:
    """counter name -> regular expression of its kernels' device names."""
    folder = os.path.join(HERE, "kernels")
    return {f[:-5]: load_json(os.path.join(folder, f))["pattern"]
            for f in sorted(os.listdir(folder)) if f.endswith(".json")}
