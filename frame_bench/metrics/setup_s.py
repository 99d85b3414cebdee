"""Host clock: from the start of ``run.py`` to the opening of the window
(imports, scene, geometry, warm-up frame, graph capture, one replay)."""


def read(run):
    return run.setup_s
