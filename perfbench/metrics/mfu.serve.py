"""Useful model flops in the traced slice over the slice at the card's bf16
peak (989 TFLOP/s), in %: each real row's trunk and its own member's head,
no padding rows, no other member's slice of the bank
(``perfbench/costs.py``)."""
from perfbench.costs import PEAK_BF16


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * s.useful_flops / (s.window_s * PEAK_BF16)
