"""step.launches: device operations (kernels, copies, fills) launched inside the
program's root ``step`` span, a step, in the plain profiled stretch
(``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.launches(run)
