"""The benchmark of merian_quake_tpu_torch, the PyTorch + CUDA port, on
NVIDIA GPUs.

One command runs one cell (a configuration under a traffic mix, named in
the repository's BENCHMARK.json) once and prints one JSON line:

    python3 -m quakebench.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything is found by name: a configuration in ``configs/<name>.json``,
a traffic mix in ``traffic/<name>.json`` (data read by ``scenes.py``),
the way a mix moves its world in ``drivers/<name>.py``, the traces of an
integrator's frame in ``tracemodels/<integrator>.py``, a metric in
``metrics/<name>.py`` (a reader of the run's record). The plain
reference that decides ``correct`` is ``reference/``; it imports nothing
of the port.
"""
