"""Mean time from a job's creation to its first execution attempt, ms:
Δsum/Δcount of theia_job_queue_wait_seconds over the window."""

from portbench import harness


def read(ctx):
    v = harness.prom_mean_delta(ctx.prom0, ctx.prom1,
                                "theia_job_queue_wait_seconds")
    return None if v is None else v * 1e3
