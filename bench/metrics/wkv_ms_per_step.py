"""Device milliseconds a step in RWKV-6's WKV scan: the kernels of the
operations inside a range around ``repro_torch.models.rwkv6.wkv_chunked``
(its forward and its recomputation) and of their backward nodes."""

UNIT = "ms"
RANGES = {"wkv": "repro_torch.models.rwkv6:wkv_chunked"}


def read(run):
    ns = run.trace.range_ns["wkv"]
    return ns / run.trace.steps / 1e6 if ns else None
