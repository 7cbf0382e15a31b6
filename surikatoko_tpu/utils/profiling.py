"""Profiling hooks: per-frame wall-clock + device tracing.

Equivalent of the reference's chrono timers around ProcessFrame
(demo-davison-mono-slam.cpp:1736-1741, "track=..ms | ..fps" VLOG), plus
jax.profiler traces and their reduction to device time per named scope.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time
from dataclasses import dataclass, field

import jax


@dataclass
class FrameTimer:
    """Streaming frame-duration stats (the 'track=..ms | ..fps' line)."""

    durations: list = field(default_factory=list)
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    @property
    def last_ms(self) -> float:
        return self.durations[-1] * 1e3 if self.durations else 0.0

    @property
    def avg_ms(self) -> float:
        return (sum(self.durations) / len(self.durations) * 1e3
                if self.durations else 0.0)

    @property
    def fps(self) -> float:
        return 1e3 / self.last_ms if self.last_ms > 0 else 0.0

    def format_line(self) -> str:
        return f"track={self.last_ms:.1f}ms | {self.fps:.1f}fps"


def median_wall_time(thunk, reps: int = 3) -> float:
    """Median host seconds of ``thunk()``, each call waited on with
    jax.block_until_ready. Warm (compile) it before calling this."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(thunk())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace of everything inside the block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in device traces (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


_HLO_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\{\s*$")
_HLO_INST = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s+=\s")
_HLO_OPNAME = re.compile(r'op_name="([^"]*)"')
_HLO_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_scope_map(hlo_text: str, scopes) -> dict:
    """Map instruction names of a compiled HLO module (``compiled.as_text()``)
    to the first of ``scopes`` (``jax.named_scope`` names) on the path of
    their ``op_name`` metadata. A fusion without a scope of its own takes
    the scope of the instructions in the computation it calls."""
    scopes = tuple(scopes)

    def scope_of(op_name):
        parts = op_name.split("/")
        return next((s for s in scopes if s in parts), None)

    comp_scope, insts, cur = {}, {}, None
    for line in hlo_text.splitlines():
        m = _HLO_COMP.match(line)
        if m:
            cur = m.group(1)
            continue
        m = _HLO_INST.match(line)
        if not m:
            continue
        op = _HLO_OPNAME.search(line)
        sc = scope_of(op.group(1)) if op else None
        insts[m.group(1)] = (sc, _HLO_CALLS.findall(line))
        if sc is not None and cur is not None:
            comp_scope.setdefault(cur, sc)
    out = {}
    for name, (sc, calls) in insts.items():
        sc = sc or next((comp_scope[c] for c in calls if c in comp_scope),
                        None)
        if sc is not None:
            out[name] = sc
    return out


def device_time_by_scope(xplane_path: str, hlo_text: str, scopes,
                         plane_prefix: str = "/device:GPU") -> dict:
    """Reduce a ``jax.profiler`` trace to device time per named scope.

    Counts the events that carry an ``hlo_op`` stat on the planes whose name
    starts with ``plane_prefix`` (on a GPU trace, only the stream lines when
    the plane has any). Busy time is the union of those events' intervals,
    the window runs from the first start to the last end, and each event's
    duration goes to the scope of its HLO instruction (``hlo_scope_map``),
    or to "other". Times are in nanoseconds."""
    from jax.profiler import ProfileData

    smap = hlo_scope_map(hlo_text, scopes)
    by_scope = collections.defaultdict(float)
    unscoped = collections.Counter()
    ivs = []
    line_names = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        line_names += [ln.name for ln in lines]
        streams = [ln for ln in lines if "Stream" in ln.name]
        for line in streams or lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                ivs.append((ev.start_ns, ev.end_ns))
                sc = smap.get(op, "other")
                by_scope[sc] += ev.duration_ns
                if sc == "other":
                    unscoped[op] += ev.duration_ns
    busy, end = 0.0, None
    for lo, hi in sorted(ivs):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    window = (max(hi for _, hi in ivs) - min(lo for lo, _ in ivs)
              if ivs else 0.0)
    return {"window_ns": window, "busy_ns": busy,
            "idle_share": 1.0 - busy / window if window else None,
            "n_events": len(ivs), "by_scope": dict(by_scope),
            "top_unscoped": unscoped.most_common(10),
            "lines": line_names}
