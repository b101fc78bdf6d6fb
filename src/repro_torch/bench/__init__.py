"""The port's benchmarks (ports of ``benchmarks/*.py``), each runnable as
``python -m repro_torch.bench.<name>``; artifacts go to ``artifacts/torch/``
(never ``artifacts/benchmarks/``, which the JAX package's CI reads).  Every
input (zoo params, request payloads, probe batches, camera frames) can be
injected, so the CPU parity tests feed both packages the same numbers; run
alone, a bench draws its own from numpy."""
