"""The device: the share of the traced whole studies' wall time in which
no kernel, copy or fill ran on it."""

from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
