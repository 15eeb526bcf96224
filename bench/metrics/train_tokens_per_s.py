"""Tokens trained a second: every group's tokens of every step in the
window (the Byzantine group's too: the card computes its gradient before
the attack replaces it) over the window's time on the host clock, the
window ending at a synchronize."""
from bench import inputs

UNIT = "tokens/s"


def read(run):
    return inputs.tokens_per_step(run.cell.traffic) * run.steps / run.seconds
