"""``mfu.serve`` in a cell whose end-to-end metric is the tokens it
completes (it moves ``serve_tokens_per_s``)."""
from perfbench.common import load_reader

read = load_reader("mfu.serve")
