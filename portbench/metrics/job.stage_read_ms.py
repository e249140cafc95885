"""Mean time of the read stage of one job of the cell's kind, ms: the
whole `job.stage` spans (runner/progress.py) of stage read in the traced
run's capture."""

from portbench import spans


def read(ctx):
    return spans.stage_ms(ctx, "read")
