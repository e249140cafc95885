"""Mean time of one fused scoring step (staging, the step over every
shard's slice, the result fetch), ms: Δsum/Δcount of
theia_fused_step_seconds over the window."""

from portbench import harness


def read(ctx):
    v = harness.prom_mean_delta(ctx.prom0, ctx.prom1,
                                "theia_fused_step_seconds")
    return None if v is None else v * 1e3
