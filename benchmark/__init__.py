"""The port's benchmark: one cell of ``BENCHMARK.json`` a run (``run.py``).

Configurations, traffic mixes, cells and metric readers are files found by name
under ``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``; the plain
reference is ``reference/``; ``reckon.py`` holds the yardstick's counts and
``check.py`` the comparison that decides ``correct``.
"""
