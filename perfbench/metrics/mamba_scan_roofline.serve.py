"""``mamba_scan``'s share of its roofline in the traced slice, in %: the bounds
of its calls above the 50 MB L2 (``perfbench/costs.py``) over their
device time.  Nothing where no call was above the L2."""


def read(run):
    s = run.summary
    hit = s.rooflines.get("mamba_scan") if s is not None else None
    return 100.0 * hit[0] / hit[1] if hit else None
