"""How a loop starts the other ranks of a cell that spans several cards.

    group = ranks.start(n, target, args, timeout_s)  # ranks 1 .. n-1
    with group:
        group.init()        # rank 0's process group, in the caller
        ...                 # rank 0: set-up, window, snapshots
        group.join()        # after the window: every rank ended, exit 0
    peak = max(rank_0_peak, group.memory_peak_bytes)

Ranks 1 .. n-1 are spawned processes (`torch.multiprocessing`), one a
card: each sets its card (`torch.cuda.set_device(rank)`), joins the process
group (NCCL; gloo with `device="cpu"`, as the harness's tests run on the
CPU) through the TCP store that `start` opened, at a port the system chose,
before any rank was spawned, and runs `target(rank, n, *args)`. Then it
leaves the group, fails if it holds a module that `run.py` forbids (as
`run.py` checks rank 0), and reports its card's memory peak. `target` is a
function at the top level of a module, found again in the spawned process
by its module's name or else by its file (a loop file, which the harness
loads by path); `args` are pickled. Rank 0 is the caller's own process, so
the device count and the checks of `run.py` stay as they are; the loop
reports the fullest card's peak, the larger of its own and
`memory_peak_bytes`.

A rank that fails must fail the run, not stall it. `join()` raises if a
rank exited non-zero, or did not end within `timeout_s` of the call; the
ranks still alive are then ended. Before `join()`, rank 0 may be waiting in
a collective for a rank that has died: a watchdog thread then ends the
ranks and the whole process (exit code 3, no result). A rank that hangs
holds rank 0 in a collective for at most `GROUP_S`, the timeout of every
collective of the group and of its rendezvous. Leaving the `with` block
ends every rank still alive and waits for each.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import sys
import threading
import time

HOST = "127.0.0.1"
ABORT_EXIT = 3
GROUP_S = 300.0
POLL_S = 0.1
END_S = 10.0  # how long an ended rank has to exit before it is killed


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_S)


def init_group(rank: int, n: int, store, device: str) -> None:
    """Sets this process's card (on CUDA) and joins the process group."""
    import torch
    import torch.distributed as dist
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo", store=store, world_size=n,
        rank=rank, timeout=_timeout(), **kw)


def _find(module: str, file: str, name: str):
    try:
        mod = importlib.import_module(module)
    except ImportError:
        from portbench.lib.spec import load_module
        mod = load_module(file)
    return getattr(mod, name)


def _rank(index, n, port, device, where, args, peaks) -> None:
    """Rank index + 1, from start to end."""
    import torch
    import torch.distributed as dist
    rank = index + 1
    if device == "cpu":
        torch.set_num_threads(1)
    target = _find(*where)
    init_group(rank, n, dist.TCPStore(HOST, port, n, timeout=_timeout()),
               device)
    try:
        target(rank, n, *args)
    finally:
        dist.destroy_process_group()
    from portbench.lib.drivers import memory_peak
    from portbench.run import forbidden_modules
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"rank {rank}: loaded in this process: {bad}")
    peaks.put(memory_peak(device))


class Ranks:
    """Ranks 1 .. n-1 of one run, and rank 0's part in the group. Only the
    watchdog looks at the ranks until `join()` or the end of the `with`
    block has stopped it."""

    def __init__(self, n, procs, store, peaks, device, timeout_s):
        self.n = n
        self.procs = procs  # torch's ProcessContext
        self.store = store
        self.peaks = peaks
        self.device = device
        self.timeout_s = timeout_s
        self.memory_peak_bytes = 0
        self.inited = False
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True,
                                       name="ranks.watchdog")
        self._watch.start()

    def init(self) -> None:
        """Joins the process group as rank 0, on card 0."""
        init_group(0, self.n, self.store, self.device)
        self.inited = True

    def _watchdog(self) -> None:
        try:
            while not self._done.is_set() and not self.procs.join(POLL_S):
                pass
        except Exception as e:  # a rank failed; torch has ended the rest
            print(f"ranks: {e}\nranks: ending the run", file=sys.stderr,
                  flush=True)
            os._exit(ABORT_EXIT)

    def _stop_watching(self) -> None:
        self._done.set()
        self._watch.join()

    def join(self) -> None:
        """Waits up to `timeout_s` for every rank to end; raises, with the
        ranks ended, if one exited non-zero or is still running. Then
        reads the ranks' memory peaks and leaves rank 0's process group."""
        until = time.monotonic() + self.timeout_s
        self._stop_watching()
        while not self.procs.join(max(0.0, until - time.monotonic())):
            if time.monotonic() >= until:
                self._end()
                raise RuntimeError(f"ranks did not end within "
                                   f"{self.timeout_s} s of the window")
        peaks = []
        while not self.peaks.empty():
            peaks.append(self.peaks.get())
        if len(peaks) < self.n - 1:
            raise RuntimeError(f"{self.n - 1 - len(peaks)} rank(s) ended "
                               "without finishing")
        self.memory_peak_bytes = max(peaks, default=0)
        self._leave()

    def _end(self) -> None:
        """Ends every rank still alive and waits until each has ended."""
        for p in self.procs.processes:
            if p.is_alive():
                p.terminate()
        for p in self.procs.processes:
            p.join(END_S)
            if p.is_alive():
                p.kill()
                p.join()

    def _leave(self) -> None:
        if self.inited:
            import torch.distributed as dist
            dist.destroy_process_group()
            self.inited = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_) -> None:
        self._stop_watching()
        self._end()
        # An NCCL group whose peers were ended may not come apart cleanly;
        # the process is ending with the error then, so it stays.
        if exc_type is None or self.device == "cpu":
            self._leave()


def start(n: int, target, args: tuple = (), timeout_s: float = 60.0, *,
          device: str = "cuda") -> Ranks:
    """Spawns ranks 1 .. n-1, each running `target(rank, n, *args)` in a
    process group of n ranks; the caller is rank 0 (`Ranks.init`)."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    store = dist.TCPStore(HOST, 0, n, is_master=True, wait_for_workers=False,
                          timeout=_timeout())
    where = (target.__module__, sys.modules[target.__module__].__file__,
             target.__name__)
    peaks = multiprocessing.get_context("spawn").SimpleQueue()
    procs = tmp.start_processes(
        _rank, (n, store.port, device, where, args, peaks), nprocs=n - 1,
        join=False, start_method="spawn")
    return Ranks(n, procs, store, peaks, device, timeout_s)
