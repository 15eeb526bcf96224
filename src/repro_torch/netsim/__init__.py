"""repro_torch.netsim — the port's copy of ``repro.netsim``, the
event-driven cluster/network simulation for ByzSGD (numpy only).

Replaces the uniform q-of-n abstraction of Assumption 7 with a discrete-event
simulation of the actual scatter/gather message schedule: per-link latency
models, fault injectors (crash/recovery, partitions, drops/duplication, slow
churn), and per-node message/byte accounting. A run produces a
:class:`~repro_torch.netsim.cluster.NetsimTrace` whose *realized* per-step
quorums and staleness tensors plug into the simulator and the protocol
through :class:`repro_torch.core.quorum.TraceDelivery`. The seeded numpy
streams, the ``zlib`` stream ids and the event heap's order are the JAX
package's, so one scenario gives the same trace in both packages.

Quick start::

    from repro_torch.netsim import scenarios, cluster
    sc = scenarios.build("heavy_tail_stragglers", steps=20)
    trace = cluster.ClusterSim(sc).run()
    print(trace.ledger.summary(sc))
    delivery = trace.to_delivery("cuda")   # tables staged on the card
"""
from . import accounting, cluster, events, faults, flood, latency, scenarios  # noqa: F401
from .cluster import ClusterSim, NetsimTrace  # noqa: F401
from .flood import FloodTrace, RequestFloodScenario, run_flood  # noqa: F401
from .scenarios import SCENARIOS, Scenario  # noqa: F401
