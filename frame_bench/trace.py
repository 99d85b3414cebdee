"""The device trace of a short steady stretch of a ``--trace 1`` window.

``torch.profiler`` (CPU and CUDA activity) runs from the input of frame
``after`` to the image of frame ``after + n`` on the host. From its
events this module takes every device operation (kernels, copies,
memsets: CUPTI reports each kernel of a replayed CUDA graph) and the
harness's own spans (``record_function`` ranges named
``frame_bench.<span>.<frame>``), all on the profiler's one clock. The
stretch's span runs from the first traced frame's issue to the last
traced frame's image on the host; busy time and idle gaps are read over
it. A traced frame's own operations are those launched while the host
was in that frame's ``issue`` span: the profiler links each device
operation to the host-side range that was open when it was launched
(for a replayed graph's kernels, the range around the graph's launch),
so kernel times are summed over the traced frames' own operations,
whatever else (the frames before and after, in flight) overlaps the
span, and however the program stages its input.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

MAX_ENTRIES = 10  # entries of each breakdown list


@dataclasses.dataclass
class Stretch:
    frames: list  # the traced frames' numbers
    profiled: list  # the frames the profiler ran over: the lead-in frame and the stretch
    span: tuple  # (start, end) seconds on the profiler's clock
    ops: list  # device operations (name, start, end) seconds, clipped to the span
    spans: list  # harness spans (name, frame, start, end) seconds
    frame_ops: list  # the traced frames' own device operations (name, start, end)

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, sorted."""
        merged: list = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, contains: str = "") -> float:
        """Summed device time of the traced frames' kernels (not copies or
        memsets) whose name holds ``contains``."""
        return sum(e - s for n, s, e in self.frame_ops if is_kernel(n) and contains in n)

    def idle_gaps(self) -> list:
        """(label, seconds) of every idle gap of the span, longest first,
        labelled by the harness span the host was in at its middle."""
        gaps, cursor = [], self.span[0]
        for s, e in self.busy_intervals() + [[self.span[1], self.span[1]]]:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            label = next((n for n, _, a, b in self.spans if a <= mid <= b), "host_loop")
            out.append((label, e - s))
        return sorted(out, key=lambda g: -g[1])

    def device_ops(self) -> list:
        """The traced frames' (name, seconds) summed by short name
        (:func:`short_name`), most time first."""
        total = collections.Counter()
        for n, s, e in self.frame_ops:
            total[short_name(n)] += e - s
        return total.most_common()

    def breakdown(self) -> dict:
        return {
            "device_ops": [[n, s] for n, s in self.device_ops()[:MAX_ENTRIES]],
            "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:MAX_ENTRIES]],
        }


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``at::native::vectorized_elementwise_kernel``,
    ``raster_kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip()


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "frame_bench."))


class Tracer:
    """Starts the profiler before frame ``after`` (a lead-in frame: the
    profiler's start may wait for the device, so the stretch begins one
    frame later) and stops it once frame ``after + n``'s image is on the
    host; the stretch is frames ``after + 1`` to ``after + n``."""

    def __init__(self, after: int, n: int):
        if after < 1 or n < 1:
            raise ValueError("a traced stretch needs a lead-in frame and at least one frame")
        self.first, self.last = after + 1, after + n
        self.profiled = list(range(after, after + n + 1))
        self.prof = None
        self.stopped = False

    def before(self, k: int) -> None:
        if k == self.first - 1:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def done(self, k: int) -> None:
        if k == self.last and self.prof is not None and not self.stopped:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.stopped = True

    def stretch(self) -> Stretch | None:
        """The stretch, read once the window has closed (None if the
        window closed before its last frame)."""
        if not self.stopped:
            return None
        device, host = _events(self.prof)
        spans = []
        for name, s, e in host:
            _, span, frame = name.rsplit(".", 2)
            spans.append((span, int(frame), s, e))
        frames = list(range(self.first, self.last + 1))
        try:
            start = min(s for n, k, s, _ in spans if n == "issue" and k == self.first)
            end = max(e for n, k, _, e in spans if n == "fetch_wait" and k == self.last)
        except ValueError:  # the window closed inside the stretch
            return None
        ops = [(n, max(s, start), min(e, end)) for n, s, e, _ in device if e > start and s < end]
        own = frame_ops(device, spans, frames)
        if own is None:
            return None
        return Stretch(frames, self.profiled, (start, end), ops, spans, own)


def frame_ops(device: list, spans: list, frames: list) -> list | None:
    """The device operations (name, start, end) of ``frames``: those
    whose launch (the fourth field of ``device``, on the host's clock)
    lies inside one of those frames' ``issue`` spans. None if a frame of
    them has no ``issue`` span or no operation."""
    issue = {k: (a, b) for n, k, a, b in spans if n == "issue" and k in frames}
    own = {k: [] for k in frames}
    for name, s, e, launched in device:
        if launched is None:
            continue
        for k, (a, b) in issue.items():
            if a <= launched <= b:
                own[k].append((name, s, e))
                break
    if len(issue) < len(frames) or not all(own.values()):
        return None
    return sorted((op for ops in own.values() for op in ops), key=lambda op: op[1])


def _events(prof):
    """(device operations (name, start s, end s, launch s or None),
    harness spans (name, start s, end s)). A device operation's launch is
    the start of the host-side range the profiler links it to (its
    ``linked_correlation_id``: the innermost operator or
    ``record_function`` open when the runtime call was made), or else the
    start of the runtime call that launched it."""
    def times(ev):
        if hasattr(ev, "start_ns"):
            return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        return ev.start_us() * 1e-6, ev.duration_us() * 1e-6

    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    # host-side ranges (operators, record_function) link to nothing; the
    # runtime and driver calls (cuda*, cu*) that launch work share their
    # own correlation id with the work, which serves where the link is 0
    host_side = [ev for ev in events if ev.device_type() != cuda and ev.correlation_id() > 0]
    opened = {ev.correlation_id(): times(ev)[0] for ev in host_side
              if ev.linked_correlation_id() == 0 and not ev.name().startswith("cu")}
    called = {ev.correlation_id(): times(ev)[0] for ev in host_side if ev.name().startswith("cu")}
    device, host = [], []
    for ev in events:
        name = ev.name()
        start, dur = times(ev)
        on_device = ev.device_type() == cuda
        if name.startswith("frame_bench."):
            if not on_device:
                host.append((name, start, start + dur))
        elif on_device:
            launched = opened.get(ev.linked_correlation_id()) if ev.linked_correlation_id() else None
            device.append((name, start, start + dur, called.get(ev.correlation_id()) if launched is None else launched))
    return device, host
