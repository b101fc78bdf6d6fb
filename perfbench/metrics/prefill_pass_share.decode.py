"""The share of the trunk passes that fed prompt tokens through prefill
chunks: ``trunk_passes["run"]`` (one pass a token of a chunk dispatch, one
a step dispatch) less the step dispatches (``trunk_dispatches`` and
``singleton_dispatches``), over ``trunk_passes["run"]``, before the
profiler started."""


def read(run):
    n = run.stats.get("trunk_passes")
    return (n - run.stats["step_passes"]) / n if n else None
