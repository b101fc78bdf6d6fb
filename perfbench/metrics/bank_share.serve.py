"""The share of micro-batches whose heads fanned out through the suffix
bank: the engine's ``bank_hits`` over its ``microbatches``, before the
profiler started.  About 1 where micro-batches mix members, 0 where each
holds one member."""


def read(run):
    n = run.stats.get("microbatches")
    return run.stats["bank_hits"] / n if n else None
