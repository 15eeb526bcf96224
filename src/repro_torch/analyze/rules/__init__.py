"""Rule modules register themselves on import (see ``analyze.registry``).

Layer-1 rules (AST and CUDA text, nothing imported) import eagerly; the
layer-2 run on the CPU (``analyze.run``) and the layer-3 card check
(``analyze.card``) register their rules here too but defer every import
of the port to check time, so ``python -m repro_torch.analyze`` stays
fast.
"""
from . import (build_key, cuda_audit, dead_seed, determinism,  # noqa: F401
               env_hygiene, host_sync, membership_floor, preconditions,
               registry_parity, taint_byz)
from .. import card, run  # noqa: F401  (register the REPRO-RUN-*/CARD-* rules)
