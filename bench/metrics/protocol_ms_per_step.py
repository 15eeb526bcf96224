"""Device milliseconds a step outside the model: every kernel of the
traced steps less those of the model, which are the kernels of the
operations inside a range around the bundle's loss and of their backward
nodes (recomputation included). What is left is the protocol: the pulls
and the DMC gather, the flat gradient copies, the attack, the Gram and
MDA's weights, the aggregation and the update."""

UNIT = "ms"
RANGES = {"model": "bundle.loss"}


def read(run):
    t = run.trace
    if not t.device_ns:
        return None
    return (t.device_ns - t.range_ns["model"]) / t.steps / 1e6
