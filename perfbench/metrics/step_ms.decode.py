"""Milliseconds per ``StreamingDecoder`` step over the window's stretch
before the profiler started."""


def read(run):
    n = run.stats.get("steps")
    return run.stats["counted_s"] / n * 1e3 if n else None
