"""Mean wall time of one job execution in the manager, s: Δsum/Δcount
of theia_job_run_seconds{kind} over the window. job_s minus this is
what the API, the polls and the delete add."""

from portbench import harness

#: the manager's job kind of each API resource
KIND = {"spatialanomalydetections": "sad",
        "throughputanomalydetectors": "tad"}


def read(ctx):
    return harness.prom_mean_delta(
        ctx.prom0, ctx.prom1, "theia_job_run_seconds",
        kind=KIND[ctx.traffic["resource"]])
