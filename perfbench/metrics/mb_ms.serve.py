"""Milliseconds inside the harness's ``MergeAwareEngine.serve`` calls per
micro-batch the engine ran (its ``microbatches`` counter), over the calls
made before the profiler started."""


def read(run):
    n = run.stats.get("microbatches")
    return run.stats["serve_s"] / n * 1e3 if n else None
