"""The port's benchmark: one cell of ``BENCHMARK.json`` a run (``run.py``).

Systems, configurations, traffic mixes, cells and metric readers are files
found by name under ``systems/``, ``configs/``, ``traffic/``, ``workloads/`` and
``metrics/``; the plain reference is ``reference/``; ``reckon.py`` holds the
yardstick's counts and ``check.py`` the seg+track step's comparison.
"""
