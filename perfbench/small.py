"""Small sizes of the cells for CPU tests: the same harness, engine and
checks, at widths and loads a test run holds."""

# a decode window ends early once its backlog is served, so a long one costs
# nothing on a fast host and still completes requests on a loaded one
SECONDS = {"stablelm-1.6b.decode-chat": 60.0, "falcon-mamba-7b.serve-mixed": 1.5,
           "stablelm-1.6b.serve-bursty": 1.5}

TINY_DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                  vocab_size=512, dtype="float32")
TINY_SSM = dict(n_layers=2, d_model=64, d_inner=128, d_state=8, dt_rank=4, vocab_size=512,
                dtype="float32")

OVERRIDES = {
    "stablelm-1.6b.decode-chat": {
        "model": TINY_DENSE,
        "cell": {"decoder": {"max_slots": 4, "buckets": [1, 2, 4], "page_size": 4,
                             "max_len": 64, "num_pages": 64, "chunked_prefill": True},
                 "buckets": [1, 2, 4]},
        "mix": {"arrivals": {"kind": "backlog", "requests": 16, "block": 8},
                "prompt": {"dist": "lognormal", "median": 10, "sigma": 0.7, "min": 4,
                           "max": 30},
                "output": {"dist": "lognormal", "median": 4, "sigma": 0.7, "min": 2,
                           "max": 10}}},
    # pairs due together: a tiny model on a host serves single requests as
    # fast as they come, and a micro-batch of several rows is what the cell's
    # load gives on the card
    "falcon-mamba-7b.serve-mixed": {
        "model": TINY_SSM, "cell": {"rate_per_s": 40.0},
        "mix": {"arrivals": {"kind": "poisson", "burst": 2},
                "prompt": {"dist": "fixed", "tokens": 16}}},
    "stablelm-1.6b.serve-bursty": {
        "model": TINY_DENSE, "cell": {"rate_per_s": 64.0},
        "mix": {"prompt": {"dist": "fixed", "tokens": 16}}},
}

# the control's size for a test run: bf16 as the cells, 4 layers of width 256
CONTROL_MODEL = {
    "stablelm-1.6b.decode-chat": dict(TINY_DENSE, d_model=256, n_heads=4, head_dim=64,
                                      d_ff=512, vocab_size=2048, n_layers=4,
                                      dtype="bfloat16"),
    "falcon-mamba-7b.serve-mixed": dict(TINY_SSM, d_model=256, d_inner=512, vocab_size=2048,
                                        n_layers=4, dtype="bfloat16"),
    "stablelm-1.6b.serve-bursty": dict(TINY_DENSE, d_model=256, n_heads=4, head_dim=64,
                                       d_ff=512, vocab_size=2048, n_layers=4,
                                       dtype="bfloat16"),
}
