"""What a ``--trace 1`` run reads: the device's activity from
``torch.profiler`` (CUPTI on the card), the benchmark's own spans
(``record_function`` ranges on the same timeline), and the wavefront
kernel's launches with their operands' shapes, lengths and ``eps``.

Spans are the benchmark's, around its calls into the program
(``perfbench.window``, ``perfbench.batch``); spans inside the program are
a later change.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

#: chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: a kernel's name in the breakdown is cut to this many characters (the
#: demangled templates of torch's kernels run to a thousand)
NAME_CHARS = 120

Interval = Tuple[float, float]


class Trace:
    """One profiler session reduced to intervals in seconds on the
    profiler's own clock: device activity (with names) and the
    benchmark's spans."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str]] = []
        self.spans: Dict[str, List[Interval]] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat = str(e.get("cat", "")).lower()
            name = str(e.get("name", ""))
            if cat in DEVICE_CATS:
                self.device.append((a, b, name))
            elif cat == "user_annotation" and name.startswith("perfbench."):
                self.spans.setdefault(name, []).append((a, b))
        self.device.sort()
        self._busy = union([(a, b) for a, b, _ in self.device])

    @property
    def has_device(self) -> bool:
        return bool(self.device)

    def span(self, name: str) -> Optional[Interval]:
        """The one span of ``name`` (``None`` if it was not recorded)."""
        got = self.spans.get(name)
        return got[0] if got else None

    def busy_in(self, lo: float, hi: float) -> float:
        """Seconds in ``[lo, hi]`` in which some device operation ran."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self._busy
                   if b > lo and a < hi)

    def kernel_s(self, substring: str, lo: float, hi: float) -> float:
        """Summed duration of the device kernels whose name holds
        ``substring`` and that start inside ``[lo, hi]``."""
        return sum(b - a for a, b, n in self.device
                   if substring in n and lo <= a <= hi)

    def top_ops(self, lo: float, hi: float, k: int = 10
                ) -> List[List]:
        """The ``k`` device operations that took most time in the window,
        summed by name."""
        tot: Dict[str, float] = {}
        for a, b, n in self.device:
            if lo <= a <= hi:
                tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n[:NAME_CHARS], s] for n, s in
                sorted(tot.items(), key=lambda t: -t[1])[:k]]

    def idle_gaps(self, lo: float, hi: float, k: int = 10) -> List[List]:
        """The ``k`` longest device-idle gaps in the window, each named by
        the innermost benchmark span open at its middle."""
        gaps, t = [], lo
        for a, b in self._busy:
            if b <= lo:
                continue
            if a >= hi:
                break
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < hi:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            label, width = "no span", float("inf")
            for name, ivs in self.spans.items():
                if name == "perfbench.window":
                    continue
                for s, e in ivs:
                    if s <= mid <= e and e - s < width:
                        label, width = name, e - s
            out.append([label, b - a])
        return out


def union(intervals: List[Interval]) -> List[Interval]:
    """Disjoint, sorted union of intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@contextlib.contextmanager
def profiled(torch, on_device: bool):
    """Profile the body; yields a one-item list that holds the
    :class:`Trace` once the body has ended.  The chrome trace passes
    through a temporary file under ``TMPDIR``, deleted after reading."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    box: List[Trace] = []
    with profile(activities=acts) as prof:
        yield box
        if on_device:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            box.append(Trace(json.load(f)["traceEvents"]))
    finally:
        os.unlink(path)


class Launches:
    """Records each wavefront launch (mode, operand shapes, lengths and
    ``eps``) while :attr:`on` is set, by wrapping the two functions the
    program's ``wavefront`` entry calls (the kernel and its plain
    version)."""

    def __init__(self, wf):
        self.wf = wf
        self.on = False
        self.rows: List[tuple] = []

    def __enter__(self):
        self._orig = (self.wf.wavefront_cuda, self.wf.wavefront_torch)

        def wrap(fn):
            def recorded(xs, ys, lens, eps, *, mode):
                if self.on:
                    self.rows.append((mode, tuple(xs.shape),
                                      tuple(ys.shape), lens, eps))
                return fn(xs, ys, lens, eps, mode=mode)
            return recorded

        self.wf.wavefront_cuda = wrap(self._orig[0])
        self.wf.wavefront_torch = wrap(self._orig[1])
        return self

    def __exit__(self, *exc):
        self.wf.wavefront_cuda, self.wf.wavefront_torch = self._orig

    def bound_s(self, cost) -> float:
        """Summed least time of the recorded launches by the frozen
        ``wavefront_cost`` at the H100's published peaks."""
        total = 0.0
        for mode, xshape, yshape, lens, eps in self.rows:
            lens = lens.cpu().numpy()
            c = cost.wavefront_cost(
                mode, np.empty(xshape, np.int8), np.empty(yshape, np.int8),
                lens[:, 0], lens[:, 1], eps)
            total += c["bound_ms"] * 1e-3
        return total
