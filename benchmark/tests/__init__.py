"""CPU and card tests of the benchmark harness (``python -m pytest benchmark/tests``)."""
