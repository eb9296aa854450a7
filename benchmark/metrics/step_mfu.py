"""step_mfu: a step's FLOPs (``reckon.step_flops``, from the configuration's
shapes) over what the card's bf16 peak does in the time a step takes where no
profiler runs (``plain_step_s``, the traced run's unprofiled steps)."""

from benchmark import reckon


def read(run):
    if run.plain_step_s <= 0 or not run.step_flops:
        return None
    return 100.0 * run.step_flops / (run.plain_step_s * reckon.BF16_FLOP_PER_S)
