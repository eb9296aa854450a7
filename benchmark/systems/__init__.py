"""The systems under test, one module a kind of step; a configuration names
its system (``"system"`` in ``configs/<config>.json``) and ``run.py`` loads
``systems/<system>.py`` by that name.

A system module gives ``setup(cell, seed, device, mark, fault=None)``.  ``cell``
is the cell's file with its configuration (``cell["cfg"]``) and traffic mix
(``cell["tr"]``) loaded; set-up makes the inputs and weights from ``seed`` on
``device``, builds the program, and calls ``mark(name)`` after each part of
set-up it wants timed apart.  ``fault(step)``, where given, wraps the timed
step (the tests plant faults so).  It returns an object with:

  * ``names``: the numbers its check may compare, in the order they are printed;
  * ``initial()``: the state the first step starts from;
  * ``outputs()``: a fresh host buffer for one step's outputs;
  * ``hand(i, state, into) → (record, state)``: hands step ``i`` in, its
    outputs bound for ``into``, and returns at once; the record holds ``hand``
    and ``ret`` (host seconds at the hand-in and when the step call returned),
    ``frames`` (the work the step completes, in the unit of the throughput
    metric), and ``event`` (recorded after the outputs' copies; the harness
    waits on it and sets ``done``) or, for a step that returns its outputs
    already on the host, ``done`` itself;
  * ``check(checked) → {name: number}``: after the window, the program freed
    first, the plain reference's judgement of the checked steps (each
    ``{"i", "pre", "post", "out"}``: the step, its state before and after, the
    buffer its outputs went to);
  * ``step_flops()``: the FLOPs of one step, counted from the configuration's
    shapes.

The harness keeps two steps in flight: it hands step i + 1 in before it waits
for step i.  A step that sets ``done`` runs with one in flight, through the
same loop.  Every traffic mix gives ``check_steps``: the harness checks the first
step and that many more, at times drawn from the seed.
"""
