"""The metric arithmetic on synthetic timings: tails over all requests,
rates over the whole window, idle gaps and roofline matching."""
import types

import pytest

from perfbench import common, costs, trace
from perfbench.common import percentile
from perfbench.serve import CallClock
from perfbench.sweep import sustained


def test_percentile_is_nearest_rank_over_all_values():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95 and percentile(vals, 99) == 99
    assert percentile([3.0], 95) == 3.0
    # a request that never completed counts above every limit
    assert percentile([1.0] * 18 + [float("inf")] * 2, 95) == float("inf")
    assert percentile([1.0] * 19 + [float("inf")], 95) == 1.0


def test_call_clock_remembers_the_first_reading_since_mark():
    c = CallClock()
    a = c()
    c()
    assert c.first == a
    c.mark()
    b = c()
    assert c.first == b and b >= a


def _run(**kw):
    base = dict(stats={}, summary=None, resident_bytes=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_counter_readers():
    read = common.load_reader
    run = _run(stats={"gen_lags": [0.001] * 99 + [0.5], "microbatches": 4, "serve_s": 0.2,
                      "bank_hits": 3, "steps": 50, "counted_s": 10.0,
                      "step_passes": 100, "trunk_passes": 400},
               resident_bytes=3 * 2 ** 30)
    assert read("gen_lag_p99_ms.serve")(run) == pytest.approx(1.0)
    assert read("mb_ms.serve")(run) == pytest.approx(50.0)
    assert read("bank_share.serve")(run) == pytest.approx(0.75)
    assert read("step_ms.decode")(run) == pytest.approx(200.0)
    assert read("prefill_pass_share.decode")(run) == pytest.approx(0.75)
    assert read("resident_gib")(run) == pytest.approx(3.0)
    empty = _run()
    for name in ("gen_lag_p99_ms.serve", "mb_ms.serve", "step_ms.decode", "mfu.serve",
                 "idle_share.decode", "bank_roofline.serve", "page_gather_share.decode"):
        assert read(name)(empty) is None


def test_trace_readers_on_a_summary():
    s = trace.Summary(window_s=2.0, busy_s=1.5,
                      by_kernel={"void gather_kernel<int>(int*)": 0.3, "ampere_gemm": 1.2},
                      rooflines={"bank_matmul": (0.2, 0.4)}, useful_flops=0.5 * 2 * 989e12)
    run = _run(summary=s)
    read = common.load_reader
    assert read("idle_share.serve")(run) == pytest.approx(0.25)
    assert read("mfu.decode")(run) == pytest.approx(50.0)
    assert read("bank_roofline.decode")(run) == pytest.approx(50.0)
    assert read("page_gather_share.decode")(run) == pytest.approx(0.2)
    assert read("flash_roofline.bursty")(run) is None


def test_kernel_names_map_to_ops():
    assert trace.op_of("void bank_wgmma_kernel<__nv_bfloat16, 128>(CUtensorMap)") == "bank_matmul"
    assert trace.op_of("void mamba_scan_kernel<float, 1>(float const*)") == "mamba_scan"
    assert trace.op_of("void at::native::gather_kernel<int>(int)") is None
    assert trace.op_of("flash_mma_kernel") == "flash_attention"
    assert trace.op_of("void (anonymous namespace)::tc::bank_wgmma_kernel<128>(CUtensorMap)") \
        == "bank_matmul"
    assert trace.op_of("void (anonymous namespace)::gather_kernel<uint4>(uint4 const*)") \
        == "page_gather"


def test_idle_gaps_are_labelled_by_the_innermost_host_event():
    host = [(0, 100, "outer"), (10, 20, "inner"), (50, 60, "other")]
    gaps = [(12, 18), (52, 58), (70, 80), (110, 130)]
    got = dict(trace.label_gaps(gaps, host))
    assert got == pytest.approx({"inner": 6e-9, "other": 6e-9, "outer": 10e-9, "host": 20e-9})


def test_eager_rooflines_count_only_calls_above_the_l2():
    big = costs.Spec((3, 2048, 4096), 2), costs.Spec((3, 4096, 65024), 2)
    small = costs.Spec((3, 8, 64), 2), costs.Spec((3, 64, 64), 2)
    calls = [("bank_matmul", small, {}), ("bank_matmul", big, {})]
    s = trace.Summary(by_op={"bank_matmul": [1e-6, 2e-3]})
    got = trace.eager_rooflines(s, calls)
    c = costs.bank_matmul_cost(*big)
    assert got == {"bank_matmul": (pytest.approx(costs.bound_s("bank_matmul", c)), 2e-3)}
    # a count that disagrees with the trace gives nothing
    assert trace.eager_rooflines(trace.Summary(by_op={"bank_matmul": [1e-3]}), calls) == {}


def test_sustained_rate_rule():
    steady = [(i * 0.1, 0.2) for i in range(100)]
    growing = [(i * 0.1, 0.2 + i * 0.05) for i in range(100)]
    assert sustained(steady) and not sustained(growing)
    assert not sustained(steady + [(10.0, float("inf"))])
