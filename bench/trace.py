"""The traced segment's timeline, read from torch.profiler's Chrome trace:
device operations (kernels, copies, sets) within the segment, the busy
time as the union of their intervals, idle gaps labelled by what the host
was doing, and the kernels' time by name."""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

WINDOW = "bench.window"
SUBMIT = "bench.submit"
HARVEST = "bench.harvest"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Timeline:
    window_s: float
    busy_s: float
    device: list             # (name, start_us, dur_us), inside the window
    gaps: list               # (start_us, dur_us) idle, inside the window
    host: list               # (name, cat, start_us, dur_us)
    cells: int = 0           # live cells of the traced calls
    bases: int = 0           # live bases of the traced calls
    pairs: int = 0

    def device_seconds(self, substring: str) -> float:
        """Seconds of the device operations whose name holds
        ``substring``."""
        return sum(d for n, _, d in self.device if substring in n) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten
        longest idle gaps, each named by what the host was doing."""
        by_name: dict = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[self.host_at(s + d / 2), d / 1e6]
                              for s, d in gaps]}

    def host_at(self, t: float) -> str:
        """The harness's step and the innermost host operation at ``t``."""
        step, inner, inner_d = "host", None, None
        for n, cat, s, d in self.host:
            if s <= t <= s + d:
                if n in (SUBMIT, HARVEST):
                    step = n
                elif cat != "user_annotation" and (inner_d is None
                                                   or d < inner_d):
                    inner, inner_d = n, d
        return step if inner is None else f"{step}/{inner}"


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _union(intervals):
    """Merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def from_events(events: list) -> Timeline:
    """The timeline of a Chrome trace's ``traceEvents``."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                device.append((e["name"], s0, s1 - s0))
        elif cat in HOST_CATS:
            host.append((e["name"], cat, s, d))
    busy = _union([(s, s + d) for _, s, d in device])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1 - prev))
    return Timeline(window_s=(w1 - w0) / 1e6,
                    busy_s=sum(e - s for s, e in busy) / 1e6,
                    device=device, gaps=gaps, host=host)


def timeline(prof) -> Timeline:
    """The timeline of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events)
