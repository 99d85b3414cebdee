"""Host clock: the 90th percentile, over every frame counted in the
window, of the time from taking the frame's input (before its tick,
camera move and pack) to its image in host memory."""

import statistics


def read(run):
    latencies = [(f.t_done - f.t_input) * 1e3 for f in run.counted]
    if len(latencies) < 2:
        return None
    return statistics.quantiles(latencies, n=10, method="inclusive")[8]
