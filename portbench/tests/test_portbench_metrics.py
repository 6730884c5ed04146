"""The arithmetic of the metrics: rates and times over a window that ends
inside a call, K1's roofline bounds, and the idle share and span times from
synthetic device intervals."""

import sys
import time

import pytest
from torch.autograd import DeviceType

from portbench import harness, roofline, trace


class Sleeper:
    """A cell whose every call takes ``dt`` seconds and serves 64 lanes."""

    def __init__(self, dt):
        self.dt = dt

    def call(self):
        time.sleep(self.dt)
        return {"lanes": 64, "ipm_iters": 10, "instance": 0}


def test_window_ends_with_the_call_in_progress_and_counts_its_whole_time():
    harness.counters()  # the port's modules imported before the window
    records, window_s = harness.window(Sleeper(0.04), 0.1, "cpu")
    assert len(records) == 3  # the third call starts at 0.08 s and ends past 0.1 s
    assert window_s >= 0.12 and window_s >= sum(r["wall_s"] for r in records)
    ctx = {"calls": records, "window_s": window_s}
    assert harness.reader("lanes_per_s")(ctx) == pytest.approx(3 * 64 / window_s)
    assert harness.reader("ipm.iters_per_call")(ctx) == 10
    assert harness.reader("ipm.ms_per_iter")(ctx) == pytest.approx(
        1e3 * sum(r["wall_s"] for r in records) / 30)


def test_time_to_optimum_weighs_every_instance_alike_over_the_whole_window():
    calls = [{"instance": 0, "wall_s": 1.0}, {"instance": 1, "wall_s": 3.0}, {"instance": 0, "wall_s": 1.0}]
    # instance means 1 and 3, mean 2; the window's 5.5 s over the 5 s of walls
    ctx = {"calls": calls, "window_s": 5.5}
    assert harness.reader("time_to_optimum_s")(ctx) == pytest.approx(2.0 * 5.5 / 5.0)
    assert harness.reader("lanes_per_s")({"calls": [dict(c, lanes=0) for c in calls], "window_s": 5.5}) is None


def test_p95_and_per_solve_counters():
    calls = [{"lanes": 64, "wall_s": w / 1e3} for w in range(1, 101)]
    assert harness.reader("window.p95_ms")({"calls": calls}) == pytest.approx(95.05)
    solves = [{"wall_s": 4.0, "window_seconds": 1.0, "windows": 3},
              {"wall_s": 2.0, "window_seconds": 0.5, "windows": 1}]
    assert harness.reader("bnb.host_s_per_solve")({"calls": solves}) == pytest.approx(2.25)
    assert harness.reader("bnb.windows_per_solve")({"calls": solves}) == 2.0


@pytest.mark.parametrize("a_shape, w_shape, bound_ms, by", [
    ((504, 5504), (64, 5504), 0.0907, "flops"),
    ((200, 1280), (64, 1280), 0.00346, "bytes"),
    ((10, 200, 1280), (10, 128, 1280), 0.0666, "flops"),
])
def test_k1_roofline_bounds(a_shape, w_shape, bound_ms, by):
    kind = "NVIDIA H100 80GB HBM3"
    b = roofline.k1_bound_s(a_shape, w_shape, kind)
    assert 1e3 * b == pytest.approx(bound_ms, rel=5e-3)
    flops, nbytes = roofline.k1_work(a_shape, w_shape)
    peak = roofline.PEAKS[kind]
    assert (flops / peak["flops"] >= nbytes / peak["bytes"]) == (by == "flops")
    assert roofline.k1_bound_s(a_shape, w_shape, "another card") is None


class Ev:
    """A raw profiler event: host (CPU) or device."""

    def __init__(self, name, start, end, device=False, corr=0, link=0):
        self._v = (name, start, end, device, corr, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_idle_share_span_times_and_gaps_from_synthetic_intervals():
    events = [
        Ev("pb.window", 0, 1000),
        Ev("pb.call", 10, 990),
        Ev("pb.gram", 40, 60), Ev("cudaLaunchKernel", 45, 50, corr=7),
        Ev("pb.pcg_solve", 300, 550), Ev("aten::mul", 310, 320, corr=8),
        Ev("gram_kernel<3>", 100, 200, device=True, corr=7),  # launched outside any operator
        Ev("mul_kernel", 150, 300, device=True, link=8),
        Ev("mul_kernel", 500, 600, device=True, link=8),
        Ev("pb.gram", 110, 120, device=True),  # a span's device-side shadow: not a kernel
    ]
    red = trace.reduce_events(events)
    assert red["window_s"] == pytest.approx(1e-6)
    assert red["busy_s"] == pytest.approx(300e-9)  # [100, 300] and [500, 600]
    ctx = {"trace": red}
    assert harness.reader("device_idle_pct.lp")(ctx) == pytest.approx(70.0)
    assert harness.reader("device_idle_pct.bnb")(ctx) == pytest.approx(70.0)
    assert red["span_device_s"]["gram"] == pytest.approx(100e-9)
    assert red["span_device_s"]["pcg_solve"] == pytest.approx(250e-9)
    assert red["k1_records"] == 1 and red["linked"] == 2 and red["via_runtime"] == 1
    gaps = dict(red["idle_gaps"])
    # idle [0, 100): the window span to 10, the call, gram's span [40, 60),
    # the call; [300, 500) inside pcg_solve; [600, 1000): the call to 990,
    # then the window
    assert gaps["window"] == pytest.approx(20e-9)
    assert gaps["gram"] == pytest.approx(20e-9)
    assert gaps["pcg_solve"] == pytest.approx(200e-9)
    assert gaps["call"] == pytest.approx(460e-9)
    assert sum(gaps.values()) == pytest.approx(700e-9)
    red["gram_shapes"] = [((200, 1280), (64, 1280))]
    red["device_kind"] = "NVIDIA H100 80GB HBM3"
    k1 = harness.reader("k1_roofline")({"trace": red})
    assert k1 == pytest.approx(100 * roofline.k1_bound_s((200, 1280), (64, 1280), red["device_kind"]) / 100e-9)
    red["span_device_s"] = {}
    assert harness.reader("k1_roofline")({"trace": red}) is None


def test_foreign_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("sypha_tpu_torch", "sypha_tpu_torch.ops", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name) or type(sys)(name))
    before = set(harness.foreign_modules())
    assert not before & {"sypha_tpu", "jax", "flax"}
    for name in ("sypha_tpu.ops", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert {"sypha_tpu", "jaxlib", "flax"} <= set(harness.foreign_modules())
