"""The stretch's arithmetic on made-up events: busy time is the union of
the device operations, idle gaps are labelled by the harness span the
host was in, kernels exclude copies, and names are shortened."""

import pytest

from frame_bench.trace import Stretch, frame_ops, short_name


def _stretch():
    ops = [
        ("void raster_kernel<true>(float const*)", 0.0, 2.0),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", 1.0, 3.0),  # overlaps
        ("Memcpy DtoH (Device -> Pinned)", 5.0, 6.0),
        ("void at::native::(anonymous namespace)::cat_kernel<int>(int)", 8.0, 9.0),
    ]
    spans = [("issue", 1, 3.0, 4.5), ("fetch_wait", 1, 6.5, 7.9)]
    return Stretch([1], [0, 1], (0.0, 10.0), ops, spans, ops)


def test_busy_is_the_union_and_idle_gaps_are_labelled():
    s = _stretch()
    assert s.busy_s == pytest.approx(3.0 + 1.0 + 1.0)
    assert s.window_s == 10.0
    gaps = s.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([2.0, 2.0, 1.0])
    assert {g[0] for g in gaps[:2]} == {"issue", "fetch_wait"}
    assert gaps[2][0] == "host_loop"


def test_kernels_exclude_copies_and_names_are_short():
    s = _stretch()
    assert s.kernel_s() == pytest.approx(2.0 + 2.0 + 1.0)
    assert s.kernel_s("raster_kernel") == pytest.approx(2.0)
    assert short_name("void at::native::(anonymous namespace)::cat_kernel<int>(int)") == "at::native::cat_kernel"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    names = [n for n, _ in s.breakdown()["device_ops"]]
    assert names[0] == "raster_kernel" and "Memcpy DtoH" in names


def test_frame_ops_are_the_traced_frames_own():
    """Frames on one stream: the lead-in frame 0, traced frames 1-2, and
    frame 3 in flight when the profiler stopped. Each frame's operations
    are those launched inside its ``issue`` span, however many copies it
    makes: frame 2 stages its input in two copies, frame 1 in none."""
    spans, device = [], []
    for k in range(4):
        t = 10.0 * k
        spans.append(("issue", k, t, t + 0.5))
        spans.append(("fetch_wait", k, t + 0.6, t + 9.5))
        copies = {0: 1, 1: 0, 2: 2, 3: 1}[k]
        device += [("Memcpy HtoD (Pinned -> Device)", t + 1 + 0.1 * c, t + 1.05 + 0.1 * c, t + 0.1)
                   for c in range(copies)]
        device += [(f"kernel_{k}", t + 2, t + 8, t + 0.2), ("Memcpy DtoH (Device -> Pinned)", t + 8, t + 9, t + 0.3)]
    device.append(("kernel_unlinked", 15.0, 16.0, None))
    own = frame_ops(device, spans, [1, 2])
    assert [n for n, _, _ in own if n.startswith("kernel")] == ["kernel_1", "kernel_2"]
    assert sum(n.startswith("Memcpy HtoD") for n, _, _ in own) == 2
    assert frame_ops([op for op in device if op[0] != "kernel_3"], spans, [1, 2]) == own  # frame 3 not in the trace
    assert frame_ops([op for op in device if op[3] is None or op[3] < 20], spans, [1, 2]) is None  # frame 2 missing
    assert frame_ops(device, [sp for sp in spans if sp[1] != 2], [1, 2]) is None  # no issue span of frame 2


class _Ev:
    """A profiler event's stand-in (the methods ``_events`` reads)."""

    def __init__(self, name, device, corr, linked, start_ns, dur_ns):
        self._v = (name, device, corr, linked, start_ns, dur_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]

    def duration_ns(self):
        return self._v[5]


def test_device_operations_take_the_launch_time_of_their_host_range():
    """A graph's kernel links to the harness's issue range, a copy to the
    operator inside it, and a kernel with no link to the runtime call that
    launched it (same correlation id); host ranges' ids and the runtime's
    are separate namespaces, so an equal number does not mix them."""
    import types

    from frame_bench.trace import _events

    events = [
        _Ev("frame_bench.issue.7", False, 5, 0, 1000, 500),
        _Ev("aten::copy_", False, 6, 0, 1100, 50),
        _Ev("cudaGraphLaunch", False, 6, 5, 1200, 30),  # runtime id 6 equals the operator's
        _Ev("kernel_a", True, 6, 5, 2000, 100),
        _Ev("Memcpy DtoH (Device -> Pinned)", True, 7, 6, 2200, 10),
        _Ev("cudaLaunchKernel", False, 8, 0, 1300, 20),
        _Ev("kernel_b", True, 8, 0, 2300, 10),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: events)))
    device, host = _events(prof)
    assert [h[0] for h in host] == ["frame_bench.issue.7"]
    assert host[0][1:] == pytest.approx((1000e-9, 1500e-9))
    launched = {name: t for name, _, _, t in device}
    assert launched == pytest.approx({"kernel_a": 1000e-9, "Memcpy DtoH (Device -> Pinned)": 1100e-9,
                                      "kernel_b": 1300e-9})
