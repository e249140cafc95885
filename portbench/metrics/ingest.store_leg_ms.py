"""Mean time of the store leg of one POST /ingest (WAL append and parts
insert), ms: Δsum/Δcount of theia_ingest_stage_seconds{stage=
"store_insert"} over the window."""

from portbench import harness


def read(ctx):
    v = harness.prom_mean_delta(ctx.prom0, ctx.prom1,
                                "theia_ingest_stage_seconds",
                                stage="store_insert")
    return None if v is None else v * 1e3
