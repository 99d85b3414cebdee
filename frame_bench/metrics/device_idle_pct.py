"""CUDA events on the device's clock, untraced: 100 x (1 - the union of
each frame's device interval over the window), over the counted frames
before the profiler started. A frame's interval runs from an event
recorded as its issue began (the device reaches it once the frame before
is done, or at once when the device is idle) to the event after its
image's copy to the host; the window from the first such frame's start
to the last one's copy. So the share is the time in which the device had
no frame enqueued: the host's serial part of a frame (input, pack, the
wake from the wait), which the profiler would slow (layer: device)."""


def read(run):
    frames = [f for f in run.untraced if f.started is not None and f.event is not None]
    if len(frames) < 2:
        return None
    origin = frames[0].started
    busy, end = 0.0, None
    for f in frames:  # frames run in order on one stream: the intervals are sorted
        s, e = origin.elapsed_time(f.started), origin.elapsed_time(f.event)
        if end is None or s > end:
            busy += e - s
        elif e > end:
            busy += e - end
        end = e if end is None else max(end, e)
    window = end
    return 100.0 * (1.0 - busy / window) if window > 0 else None
