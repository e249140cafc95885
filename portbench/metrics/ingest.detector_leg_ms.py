"""Mean time of the detector leg of one POST /ingest (remap, plan and
the wait for its fused step), ms: Δsum/Δcount of
theia_ingest_stage_seconds{stage="detector"} over the window."""

from portbench import harness


def read(ctx):
    v = harness.prom_mean_delta(ctx.prom0, ctx.prom1,
                                "theia_ingest_stage_seconds",
                                stage="detector")
    return None if v is None else v * 1e3
