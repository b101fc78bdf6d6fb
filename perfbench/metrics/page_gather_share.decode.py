"""``page_gather``'s share of the device time in the traced slice."""
from perfbench.trace import op_of


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0:
        return None
    total = sum(s.by_kernel.values())
    return sum(t for n, t in s.by_kernel.items() if op_of(n) == "page_gather") / total
