"""Profiling & tracing: jax.profiler traces + per-phase throughput counters.

The reference only has ad-hoc prints (prefill/decode TPS at
model/llm/llm.py:262-270, RTF logs at cli/cosyvoice.py:74,101, the rwkvfla
print_stats harness). Here profiling is first-class (SURVEY.md §5):

  * `trace(dir)` context manager -> TensorBoard/XProf trace
  * `PhaseTimer` -> per-phase wall/tokens/RTF counters with one summary
  * `measure(fn, *args)` -> compile time vs steady-state time, fenced by
    `jax.block_until_ready`
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(x) -> None:
    """Wait until every array in `x` is computed on the device."""
    import jax

    jax.block_until_ready(x)


@dataclasses.dataclass
class PhaseStats:
    calls: int = 0
    seconds: float = 0.0
    tokens: int = 0
    audio_seconds: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def rtf(self) -> float:
        return self.seconds / self.audio_seconds if self.audio_seconds else 0.0


class PhaseTimer:
    """Accumulates per-phase timings: prefill / decode / flow / vocoder...

    with timer.phase("decode", tokens=256): ...
    """

    def __init__(self):
        self.stats: Dict[str, PhaseStats] = defaultdict(PhaseStats)

    @contextlib.contextmanager
    def phase(self, name: str, tokens: int = 0, audio_seconds: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.calls += 1
            s.seconds += dt
            s.tokens += tokens
            s.audio_seconds += audio_seconds

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "calls": v.calls,
                "seconds": round(v.seconds, 4),
                "tokens_per_s": round(v.tokens_per_s, 1),
                "rtf": round(v.rtf, 4),
            }
            for k, v in self.stats.items()
        }

    def report(self) -> str:
        lines = [f"{'phase':<12} {'calls':>6} {'sec':>9} {'tok/s':>10} {'rtf':>8}"]
        for k, v in self.stats.items():
            lines.append(
                f"{k:<12} {v.calls:>6} {v.seconds:>9.3f} "
                f"{v.tokens_per_s:>10.1f} {v.rtf:>8.4f}"
            )
        return "\n".join(lines)


def measure(fn: Callable, *args, iters: int = 3, **kw) -> Dict[str, float]:
    """(compile_s, steady_s) for a jitted callable, device-fenced."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync(out)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    sync(out)
    steady = (time.perf_counter() - t0) / iters
    return {"compile_s": compile_s, "steady_s": steady}


def busy_ns(intervals) -> int:
    """Length of the union of (start_ns, end_ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return int(total)


def device_op_times(trace_dir: str, top: int = 20) -> Dict[str, Any]:
    """Reduce the newest `.xplane.pb` under `trace_dir` (a `trace()` run).

    For each GPU device plane: the op events of its "XLA Ops" line when it
    has one, otherwise of its stream lines. Returns {plane: {"window_ms",
    "busy_ms", "idle_share", "ops": [(name, total_ms, count)] top first,
    "lines": {line name: event count}}}."""
    import glob
    import os
    from collections import Counter

    import jax

    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    out: Dict[str, Any] = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        chosen = [v for k, v in lines.items() if k == "XLA Ops"] or [
            v for k, v in lines.items() if k.startswith("Stream")
        ]
        events = [e for evs in chosen for e in evs]
        if not events:
            continue
        spans = [(int(e.start_ns), int(e.start_ns + e.duration_ns)) for e in events]
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = busy_ns(spans)
        per_op: Counter = Counter()
        count: Counter = Counter()
        for e in events:
            per_op[e.name] += e.duration_ns
            count[e.name] += 1
        out[plane.name] = {
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "ops": [(n, ns / 1e6, count[n]) for n, ns in per_op.most_common(top)],
            "lines": {k: len(v) for k, v in lines.items()},
        }
    return out


def print_device_ops(trace_dir: str, top: int = 15) -> None:
    """Print `device_op_times(trace_dir)`: window, busy time, idle share
    and the top ops of each GPU plane."""
    for plane, r in device_op_times(trace_dir, top=top).items():
        print(f"  {plane}: window {r['window_ms']:.3f} ms, busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}")
        for name, ms, n in r["ops"]:
            print(f"  {ms:9.3f} ms {100 * ms / r['busy_ms']:5.1f}% x{n:<5d} {name}")
