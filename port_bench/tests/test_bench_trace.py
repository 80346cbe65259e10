"""The trace's arithmetic on intervals made by hand: the busy time is the
union within the span (overlaps counted once), the gaps are named by the
host span they begin in, and kernel time is summed by pattern."""
import pytest

from port_bench.trace import Trace


def trace():
    device = [("copy", 0.0, 10.0),                      # before the span: clipped
              ("void sparse_rows_kernel<1>(long)", 15.0, 40.0),
              ("void din_attention_kernel<10>(float)", 30.0, 50.0),   # overlaps
              ("void sparse_rows_long_kernel<1>(long)", 70.0, 100.0)]
    spans = [("multi_step", 0.0, 5.0), ("multi_step", 12.0, 45.0), ("sync", 45.0, 101.0)]
    return Trace(device, spans, start=12.0, end=100.0, calls=2)


def test_busy_is_the_union_within_the_span():
    t = trace()
    assert t.span_ms == pytest.approx(0.088)
    assert t.busy_ms() == pytest.approx((50 - 15 + 100 - 70) / 1e3)


def test_idle_gaps_named_by_host_span():
    gaps = trace().idle_gaps()
    assert gaps == [["sync", pytest.approx(20e-6)], ["multi_step", pytest.approx(3e-6)]]


def test_device_ms_by_pattern_and_top_ops():
    t = trace()
    assert t.device_ms([r"\bsparse_rows_kernel\b"]) == pytest.approx(0.025)
    assert t.device_ms([r"\bsparse_rows_kernel\b", r"\bsparse_rows_long_kernel\b"]) == \
        pytest.approx(0.055)
    assert t.device_ms([r"\bnothing\b"]) == 0
    assert t.top_ops(2)[0] == ["void sparse_rows_long_kernel<1>(long)", pytest.approx(30e-6)]
