"""Time a job in which no operation ran on the card, ms: the mean, over
the capture's whole `job.run` spans of the cell's kind, of each span's
length less the union of the device intervals clipped to it."""

from portbench import spans


def read(ctx):
    return spans.device_idle_ms(ctx)
