"""Host clock: the window's time, from its opening to the last counted
frame's image in host memory, over the frames whose image reached host
memory inside the window."""


def read(run):
    frames = run.counted
    return run.window_s * 1e3 / len(frames) if frames else None
