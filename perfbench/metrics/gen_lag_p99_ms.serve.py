"""How late the open loop submitted requests against their due times: the
99th percentile over the requests submitted before the profiler started
(the window's first stretch; all of it in an untraced run), in ms."""
from perfbench.common import percentile


def read(run):
    lags = run.stats.get("gen_lags")
    return percentile(lags, 99) * 1e3 if lags else None
