"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` (CUPTI) records every device kernel, copy and fill
with its start and length, and every host operation. The window is the
host span ``perfbench.window``, which the harness opens right before the
window's first unit and closes after its final synchronisation. The
reduction reads the profiler's raw event list (not ``key_averages``,
whose event tree costs minutes at a window's millions of events):

- ``busy_s``: the length of the union of device intervals inside the
  window (the idle share is ``1 - busy_s / window_s``);
- ``device_seconds(patterns)``: the device time of the kernels whose
  names hold any of the patterns, and how many there were;
- ``top_ops()``: the device operations that took the most time;
- ``idle_gaps()``: the longest stretches with nothing on the device,
  each named by the innermost host operations running at its middle.

The arithmetic of busy and idle follows ``chip_smoke.py``'s
``profiled_pass`` and ``profile_steps``, taken over the interval union
instead of summed kernel time, so that concurrent kernels count once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WINDOW_SPAN = "perfbench.window"
_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(e) -> str:
    kind = getattr(e, "activity_type", None)
    return str(kind() if callable(kind) else kind or "").lower()


@dataclass
class DeviceTrace:
    window_s: float
    names: list            # device op names, one per device event
    starts: np.ndarray     # ns, inside the window
    ends: np.ndarray
    host_names: list       # host ops, one per host event
    host_starts: np.ndarray
    host_ends: np.ndarray
    t0: int
    t1: int
    _totals: dict | None = None

    @property
    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self._merged())) / 1e9

    def _merged(self) -> list:
        order = np.argsort(self.starts, kind="stable")
        merged: list = []
        for s, e in zip(self.starts[order].tolist(),
                        self.ends[order].tolist()):
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def _by_name(self) -> dict:
        if self._totals is None:
            totals: dict = {}
            for i, name in enumerate(self.names):
                ns, n = totals.get(name, (0, 0))
                totals[name] = (ns + int(self.ends[i] - self.starts[i]), n + 1)
            self._totals = totals
        return self._totals

    def device_seconds(self, patterns) -> tuple[float, int]:
        """(device seconds, events) of the ops whose names hold a
        pattern."""
        total, count = 0, 0
        for name, (ns, n) in self._by_name().items():
            if any(p in name for p in patterns):
                total += ns
                count += n
        return total / 1e9, count

    def top_ops(self, n: int = 10) -> list:
        top = sorted(self._by_name().items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:160], ns / 1e9] for name, (ns, _) in top]

    def idle_gaps(self, n: int = 10) -> list:
        gaps, last = [], self.t0
        for s, e in self._merged():
            if s > last:
                gaps.append((s - last, last, s))
            last = max(last, e)
        if self.t1 > last:
            gaps.append((self.t1 - last, last, self.t1))
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            out.append([self._host_at((s + e) // 2), length / 1e9])
        return out

    def _host_at(self, t: int) -> str:
        inside = np.nonzero((self.host_starts <= t)
                            & (self.host_ends >= t))[0]
        if inside.size == 0:
            return "host: no operation"
        inner = sorted(inside.tolist(),
                       key=lambda i: self.host_ends[i] - self.host_starts[i])
        names = [self.host_names[i] for i in inner[:2]]
        return "host: " + " < ".join(n[:80] for n in names)


def reduce_profile(prof) -> DeviceTrace | None:
    """The window's device trace from a stopped ``torch.profiler``
    profile, or None where it holds no window span or no device event."""
    events = prof.profiler.kineto_results.events()
    window = None
    dev, host = [], []
    for e in events:
        name = e.name()
        kind = _activity(e)
        start, length = int(e.start_ns()), int(e.duration_ns())
        on_device = str(e.device_type()).endswith("CUDA")
        if name == WINDOW_SPAN and not on_device:
            window = (start, start + length)
        elif on_device:
            if kind in _DEVICE_ACTIVITIES or (
                    not kind and not name.startswith("perfbench.")):
                dev.append((name, start, start + length))
        elif kind not in ("overhead",):
            host.append((name, start, start + length))
    if window is None or not dev:
        return None
    t0, t1 = window
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in dev if e > t0 and s < t1]
    host = [h for h in host if h[0] != WINDOW_SPAN and h[2] > t0
            and h[1] < t1]
    if not dev:
        return None
    return DeviceTrace(
        window_s=(t1 - t0) / 1e9,
        names=[d[0] for d in dev],
        starts=np.array([d[1] for d in dev], np.int64),
        ends=np.array([d[2] for d in dev], np.int64),
        host_names=[h[0] for h in host],
        host_starts=np.array([h[1] for h in host], np.int64),
        host_ends=np.array([h[2] for h in host], np.int64),
        t0=t0, t1=t1)
