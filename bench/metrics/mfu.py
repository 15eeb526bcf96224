"""The whole step's share of the card's bf16 peak: the model's operations
of every group's batch (six a multiplying parameter a token, the tied head
counted and the embedding's gather not; attention's or the recurrence's
own products forward and backward; no recomputation, no protocol) times
the window's steps, over the window's seconds and the published peak of
an H100 SXM at 700 W (the run prints the card's power limit)."""
from bench import yardstick
from bench.reference import protocol as ref

UNIT = "%"


def read(run):
    c, tr = run.cell.config, run.cell.traffic
    flops = tr["groups"] * ref.family(c).model_flops(
        c, tr["batch_per_group"], tr["seq"])
    return 100.0 * flops * run.steps / run.seconds / yardstick.PEAK_BF16
