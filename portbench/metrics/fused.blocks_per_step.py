"""Mean number of decoded blocks coalesced into one fused step:
Δsum/Δcount of theia_fused_coalesced_blocks over the window."""

from portbench import harness


def read(ctx):
    return harness.prom_mean_delta(ctx.prom0, ctx.prom1,
                                   "theia_fused_coalesced_blocks")
