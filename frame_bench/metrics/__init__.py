"""One reader per metric, ``read(run) -> float | None``, found by the
metric's name in ``BENCHMARK.json``; ``run`` is a
:class:`frame_bench.harness.Run`. A reader that finds nothing to read
returns None, and the metric is left out of the result line."""
