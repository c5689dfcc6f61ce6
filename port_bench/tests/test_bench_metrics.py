"""The arithmetic of the metrics: a rate is all the work over all the
window, readers return nothing when they have nothing to read."""

import pytest

from port_bench.counts import mas
from port_bench.drivers.common import Ctx
from port_bench.harness import spec, stats
from port_bench.harness.trace import DeviceOp, TraceSummary


def test_rate_is_all_work_over_all_the_window():
    assert stats.rate(120.0, 40.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def trace(ops, window_s=2.0, launches=None):
    return TraceSummary(window_s=window_s,
                        busy_s=sum(o.dur_ns for o in ops) / 1e9, ops=ops,
                        ranges={}, launches_in=launches or {},
                        host_ranges=[], host_ops=[],
                        window_ns=(0, int(window_s * 1e9)))


@pytest.mark.parametrize("name", ["device.idle_pct.batch",
                                  "device.idle_pct.train"])
def test_idle_share_and_empty_trace(name):
    assert spec.metric_path(name).name == "device.idle_pct.py"
    read = spec.metric_reader(name)
    t = trace([DeviceOp("k", 0, 500_000_000, 1)])
    assert read(Ctx(t, 2.0, {}, {}, {})) == pytest.approx(75.0)
    assert read(Ctx(None, 2.0, {}, {}, {})) is None


def test_decoder_share_by_launches():
    ops = [DeviceOp("a", 0, 300, 1), DeviceOp("b", 300, 100, 2)]
    t = trace(ops, launches={"port_bench.decode_hidden": {1}})
    read = spec.metric_reader("svs.decoder_device_pct")
    assert read(Ctx(t, 1.0, {}, {}, {})) == pytest.approx(75.0)


def test_mfu_and_roofline_readers():
    t = trace([DeviceOp("void (anonymous namespace)::mas_kernel<2>(float "
                        "const*)", 0, 1_000_000, 1),
               DeviceOp("mas_wide_kernel", 2_000_000, 1_000_000, 2)])
    nbytes = 3.35e12 * 20e-6          # 20 us at the card's bandwidth
    ctx = Ctx(t, 2.0, {}, {"steps": 1},
              {"mas_bytes": nbytes, "flops": 67e12})
    # the bytes the steps need over every MAS kernel's time, however many
    # launches the program makes
    assert spec.metric_reader("mas_kernel_roofline")(ctx) == \
        pytest.approx(1.0)
    assert spec.metric_reader("train.mfu_pct")(ctx) == pytest.approx(50.0)
    assert spec.metric_reader("train.launches_per_step")(ctx) == 2
    ctx.trace = trace([DeviceOp("other", 0, 1_000_000, 1)])
    assert spec.metric_reader("mas_kernel_roofline")(ctx) is None


def test_mas_bytes_count_each_item_at_its_size():
    assert mas.bytes_needed([(2, 3)], 4, 5) == 4 * (6 + 9 + 20)
