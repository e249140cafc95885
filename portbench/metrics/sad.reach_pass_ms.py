"""Device time a SAD job of the reach pass of its pairwise DBSCAN, ms:
the kernels and copies launched inside the `dbscan.reach_pass` spans
(ops/dbscan.py) of the capture's whole jobs, each matched by its
correlation id to a runtime call on the span's thread."""

from portbench import spans


def read(ctx):
    return spans.pass_ms(ctx, "dbscan.reach_pass")
