"""Share of the jobs' time (submit to COMPLETED, every job of the traced
window, all inside one capture) in which no operation ran on the card,
%: 1 − the union of the capture's device intervals ÷ the sum of the
jobs' times."""

from portbench.traffic.job_loop import job_trace_stats


def read(ctx):
    if ctx.trace_doc is None:
        return None
    s = job_trace_stats(ctx)
    if s["jobs_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["jobs_s"])
