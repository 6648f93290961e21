"""The traced run: spans that the benchmark opens around calls into the
program, the profiler's device trace, and the reduction of both to the
numbers that the per-layer readers take.

A span is declared by a reader (``SPANS`` in ``metrics/<name>.py``) as
``(span, where, path)``: ``where`` is ``"module:<dotted module>"`` (a
function the program looks up in that module at call time) or a root
object the runner names (``"model"``, ``"program"``, ``"trainer"``, ...),
and ``path`` the attribute to wrap (dotted under a root). The wrapper
opens ``record_function("bench:<span>:<call>")``, times the call on the
host, and keeps what the reader's ``note(args, kwargs, result)`` says of
it. A path that is gone leaves its span without calls, so its metric reads
null and the run goes on.

The device time of a call is that of every kernel, copy and fill whose
launch lies inside the call's range, on any thread (the backward launches
from autograd's thread while the caller waits). The profiler covers the
first ``TRACED_SECONDS`` of the window; calls after it keep their host
times and notes but have no device time.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
TRACED_SECONDS = 20.0  # the traced part of a --trace 1 run's window
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this many characters


class Spans:
    """The wrappers of one traced run and what they recorded."""

    def __init__(self):
        self.calls: dict[str, list[dict]] = defaultdict(list)
        self.notes: dict[str, list] = defaultdict(list)
        self.missing: list[str] = []
        self._undo: list = []

    def span(self, name: str):
        """A context for a range of the harness's own (the window)."""
        i = len(self.calls[name])
        rec = {"note": {}}
        self.calls[name].append(rec)
        return torch.profiler.record_function(f"bench:{name}:{i}")

    def wrap(self, name: str, where: str, path: str, roots: dict, note=None) -> None:
        if note is not None and note not in self.notes[name]:
            self.notes[name].append(note)
        if name in self.calls or name in self.missing:
            return
        try:
            if where.startswith("module:"):
                owner, attr = importlib.import_module(where[7:]), path
            else:
                owner = roots[where]
                *parents, attr = path.split(".")
                for p in parents:
                    owner = getattr(owner, p)
            fn = getattr(owner, attr)
        except (ImportError, AttributeError, KeyError):
            self.missing.append(name)
            return
        calls, notes = self.calls[name], self.notes[name]

        def wrapper(*args, **kwargs):
            i = len(calls)
            with torch.profiler.record_function(f"bench:{name}:{i}"):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                host_s = time.perf_counter() - t0
            noted = {}
            for n in notes:
                noted.update(n(args, kwargs, out))
            calls.append({"host_s": host_s, "note": noted})
            return out

        had = attr in getattr(owner, "__dict__", {})
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn, had))

    def install(self, readers, roots: dict) -> None:
        for reader in readers:
            for name, where, path in getattr(reader, "SPANS", ()):
                self.wrap(name, where, path, roots, getattr(reader, "note", None))

    def remove(self) -> None:
        for owner, attr, fn, had in reversed(self._undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self._undo.clear()


@contextlib.contextmanager
def profiled(enabled: bool, spans: Spans, limit_s: float = TRACED_SECONDS):
    """The profiler (CPU and CUDA activity, no shapes, no stacks, no memory)
    over the start of the block, at most ``limit_s`` seconds of it: the
    holder's ``tick()``, called by the window's loop, closes the ``window``
    range and stops the profiler once that time has passed (the trace of a
    whole window takes minutes to write and read). After the block the
    holder's ``events`` is the trace."""
    holder = type("Trace", (), {"events": None, "tick": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  profile_memory=False)
    prof.start()
    window = spans.span(WINDOW)
    window.__enter__()
    t0 = time.perf_counter()
    running = [True]

    def stop():
        if running[0]:
            running[0] = False
            window.__exit__(None, None, None)
            prof.stop()

    def tick():
        if running[0] and time.perf_counter() - t0 >= limit_s:
            stop()

    holder.tick = tick
    try:
        yield holder
    finally:
        stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: list[dict], spans: Spans) -> dict:
    """Device seconds of every recorded call, the window's length and busy
    time, the top device operations and the longest idle gaps by host
    range. Times in the trace are microseconds."""
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    device = []  # (launch ts, start, end, name)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            t = launch.get(corr, e["ts"])
            device.append((t, e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", "?")))
    device.sort()
    launches = [d[0] for d in device]
    cum = [0.0]
    for d in device:
        cum.append(cum[-1] + (d[2] - d[1]))

    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench:"):
            _, name, i = e["name"].rsplit(":", 2)
            ranges[(name, int(i))] = (e["ts"], e["ts"] + e.get("dur", 0.0))
    for name, calls in spans.calls.items():
        for i, rec in enumerate(calls):
            r = ranges.get((name, i))
            if r is None:
                continue
            lo, hi = bisect.bisect_left(launches, r[0]), bisect.bisect_right(launches, r[1])
            rec["device_s"] = (cum[hi] - cum[lo]) * 1e-6
            rec["range_s"] = (r[1] - r[0]) * 1e-6

    win = ranges.get((WINDOW, 0))
    if win is None:
        return {"busy_s": None, "window_s": None, "device_ops": [], "idle_gaps": []}
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1)) for _, s, e, _ in device if e > w0 and s < w1]
    busy = _union(inside)
    by_name: dict[str, float] = defaultdict(float)
    for _, s, e, name in device:
        if e > w0 and s < w1:
            by_name[name] += (min(e, w1) - max(s, w0)) * 1e-6
    top = [(n[:NAME_CHARS], v) for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    # idle gaps, labelled by the innermost bench range open at their middle
    host = sorted((s, e, n) for (n, _), (s, e) in ranges.items() if n != WINDOW)
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label, width = "host: outside the benchmark's ranges", None
        hi = bisect.bisect_right(starts, mid)
        for hs, he, hn in host[max(0, hi - 64): hi]:
            if hs <= mid <= he and (width is None or he - hs < width):
                label, width = f"host: {hn}", he - hs
        idle[label] += (e - s) * 1e-6
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in gaps_top],
    }
