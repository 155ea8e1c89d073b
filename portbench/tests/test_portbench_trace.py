"""The trace's reduction on synthetic profiler events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace


def ev(name, start, end, dev=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_busy_is_the_union_and_labels_are_no_operations():
    events = [
        ev(trace.MARK, 0, 100, DeviceType.CPU),
        ev("portbench.batch_search", 6, 95, DeviceType.CPU),
        ev("portbench.batch_search", 5, 95, annotation=True),   # a label
        ev("cudaGraphLaunch", 40, 60, DeviceType.CPU),
        ev("kernel_a", 10, 30), ev("kernel_b", 20, 40),          # overlap
        ev("kernel_a", 70, 80),
        ev("kernel_c", 95, 130),                                  # clipped
    ]
    t = trace.reduce_events(events, {"calls": 2})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert t.by_name["kernel_a"] == (pytest.approx(30e-6), 2)
    assert "portbench.batch_search" not in t.by_name
    idle = dict(t.idle_gaps)
    # gaps [0,10) and [80,95): no host event / the labelled call;
    # [40,70): its middle 55 falls in cudaGraphLaunch (started last)
    assert idle["cudaGraphLaunch"] == pytest.approx(30e-6)
    assert idle["portbench.batch_search"] == pytest.approx(15e-6)
    assert idle["no traced host event"] == pytest.approx(10e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "kernel_a"
    assert len(bd["idle_gaps"]) == 3
    assert t.device_seconds(lambda n: n.startswith("kernel_"))[1] == 4


def test_no_device_operation_reads_nothing():
    events = [ev(trace.MARK, 0, 100, DeviceType.CPU),
              ev("aten::add", 1, 2, DeviceType.CPU)]
    assert trace.reduce_events(events, {}) is None
