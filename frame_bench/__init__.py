"""The benchmark of the port (``syzygy_tpu_torch``): one cell per run.

    python3 frame_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; each names a configuration
(``configs/<name>.json``, whose ``scene`` is a module of ``scenes/``), a
traffic mix (``traffic/<name>.json``) and has the limits of its check
(``checks/<cell>.json``); each metric has a reader in ``metrics/``.
:mod:`frame_bench.harness` runs the loop, :mod:`frame_bench.check`
compares the window's images with the plain reference
(:mod:`frame_bench.reference`), :mod:`frame_bench.trace` reads the
device trace of a ``--trace 1`` run and :mod:`frame_bench.roofline`
counts the rasters' least work. The tests (``frame_bench/tests``) run on
the CPU at 256x128; the ``cuda``-marked ones need the card.
"""
