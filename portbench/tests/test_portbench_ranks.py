"""`lib/ranks.py` on the CPU (gloo): a cell's other ranks are started,
joined, and fail the run when one of them raises, hangs or loads a module
that `run.py` forbids; `join()` raises within the timeout plus 30 s, and a
run whose rank fails prints no result line. A failing rank ends the whole
process (the watchdog), so those cases run in a process of their own."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
import time
import types

import pytest
import torch

from portbench.lib import ranks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SLACK_S = 30.0


def summed(rank: int, n: int) -> float:
    """Every rank's id, summed over the group."""
    import torch.distributed as dist
    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    return float(t)


def misbehaves(rank: int, n: int, how: str, wait: bool) -> None:
    """The last rank raises 2 s after the group formed, hangs, or loads a
    stub module named `jax`, as `how` says; with `wait` the other ranks
    then wait for it in a collective that it never joins."""
    import torch.distributed as dist
    if rank == n - 1:
        if how == "raises":
            time.sleep(2)
            raise ValueError("a rank that fails")
        if how == "hangs":
            time.sleep(600)
        if how == "loads_jax":
            sys.modules["jax"] = types.ModuleType("jax")
    elif wait:
        dist.all_reduce(torch.ones(1))


def _python(script: str) -> tuple:
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=240)
    return out, time.monotonic() - t0


def test_ranks_join_after_a_collective():
    group = ranks.start(3, summed, timeout_s=120, device="cpu")
    with group:
        group.init()
        assert summed(0, 3) == 3.0
        group.join()
    assert [p.exitcode for p in group.procs.processes] == [0, 0]
    assert group.memory_peak_bytes == 0


JOIN = """
    import time
    from portbench.lib import ranks
    from portbench.tests.test_portbench_ranks import misbehaves
    group = ranks.start(3, misbehaves, ({how!r}, False), timeout_s={timeout},
                        device="cpu")
    with group:
        group.init()
        t0 = time.monotonic()
        try:
            group.join()
        except Exception as e:
            print(f"join raised after {{time.monotonic() - t0}} s: {{e!r}}")
    print("alive", sum(p.is_alive() for p in group.procs.processes))
"""


@pytest.mark.parametrize("how,timeout_s", [("raises", 60), ("hangs", 10)])
def test_a_rank_that_fails_makes_join_raise(how, timeout_s):
    out, _ = _python(JOIN.format(how=how, timeout=timeout_s))
    assert out.returncode == 0, out.stderr[-2000:]
    raised = re.search(r"join raised after ([0-9.]+) s", out.stdout)
    assert raised, out.stdout + out.stderr[-2000:]
    assert float(raised.group(1)) < timeout_s + SLACK_S
    assert "alive 0" in out.stdout


RUN = """
    import json
    from portbench.lib import ranks
    from portbench.tests.test_portbench_ranks import misbehaves
    ranks.GROUP_S = 10.0  # rank 0's collectives time out sooner than a run's
    group = ranks.start(3, misbehaves, ({how!r}, {wait}), timeout_s=300,
                        device="cpu")
    with group:
        group.init()
        misbehaves(0, 3, {how!r}, {wait})
        group.join()
    print(json.dumps({{"correct": True}}))
"""


@pytest.mark.parametrize("how,wait,within_s", [
    ("raises", True, 60), ("hangs", True, 10), ("loads_jax", False, 60)])
def test_a_run_whose_rank_fails_ends_with_no_result(how, wait, within_s):
    """Rank 0 waits in a collective that the failing rank never joins, or
    in `join()`: the run ends with no result line, through gloo's error,
    the collective's timeout (here 10 s), the watchdog, which ends the
    ranks and the run when a rank exits non-zero, or `join()`. A rank that
    loaded `jax` says so."""
    out, took = _python(RUN.format(how=how, wait=wait))
    assert took < within_s + SLACK_S + 30
    assert out.returncode != 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    if how == "loads_jax":
        assert "loaded in this process: ['jax']" in out.stderr, \
            out.stderr[-2000:]
