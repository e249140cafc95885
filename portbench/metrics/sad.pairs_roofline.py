"""The SAD jobs' least device time for their pairwise work ÷ the device
busy time of those jobs, %.

The work is counted from the inputs (see portbench/roofline.py): the
window's N flows, the embedding width F and the core count C that the
reference finds; the busy time is the union of the device intervals of
every job of the traced window, all inside one capture. Nothing when
the run held no SAD job or its capture saw no device work."""

from portbench import roofline
from portbench.traffic.job_loop import job_trace_stats


def read(ctx):
    if ctx.trace_doc is None or "sad_n" not in ctx.data:
        return None
    s = job_trace_stats(ctx)
    if s["busy_s"] <= 0 or s["jobs"] == 0:
        return None
    least_s, _ = roofline.sad_pairs_bound_s(
        ctx.data["sad_n"], ctx.data["sad_dim"], ctx.data["sad_core"])
    return 100.0 * s["jobs"] * least_s / s["busy_s"]
