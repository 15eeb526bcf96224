"""The :class:`Experiment` spec of ``repro.exp.spec`` — one frozen,
fully serializable object that names a ByzSGD experiment.

Same fields, defaults, ``to_dict``/``from_dict`` and ``spec_hash`` as the
JAX package, so one preset hashes alike in both. What the port does not run
yet fails at construction, naming its ``ROADMAP.md`` item: the ``netsim``,
``protocol`` and ``elastic`` runners, trace delivery, membership plans,
backend options (the port has one sort and no backend switch). A scenario
name with uniform delivery names the cluster for a netsim run and changes
nothing else, so it is accepted (the ``smoke`` preset carries one).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable

from ..configs.paper_models import make_mlp_problem
from ..core.attacks import GRADIENT_ATTACKS, MODEL_ATTACKS, ByzantineSpec
from ..core.simulator import ByzSGDConfig
from ..data.pipeline import MixtureSpec, TokenSpec
from ..optim import schedules as _schedules

# ---------------------------------------------------------------------------
# named resources: models / data / lr schedules (copies of the JAX registry)
# ---------------------------------------------------------------------------

#: model registry. ``{"hidden", "depth"}`` entries are MLPs; ``{"arch", ...}``
#: entries are zoo architectures, which train only through the protocol
#: runner and arrive with the model-zoo slice (ROADMAP Queue 1 item 8).
MODELS: dict[str, dict[str, Any]] = {
    "mlp_h32": {"hidden": 32, "depth": 2},
    "mlp_h64": {"hidden": 64, "depth": 2},
    "mlp_h128": {"hidden": 128, "depth": 2},
    "mlp_h256": {"hidden": 256, "depth": 2},
    "mlp_h1024": {"hidden": 1024, "depth": 2},
    "tfm_tiny": {"arch": "phi4-mini-3.8b", "reduced": True},
    "moe_tiny": {"arch": "qwen3-moe-235b-a22b", "reduced": True},
    "rwkv_tiny": {"arch": "rwkv6-3b", "reduced": True},
}


def is_arch_model(name: str) -> bool:
    """True iff the MODELS entry is a zoo architecture."""
    return "arch" in MODELS[name]


#: data registry: MixtureSpec entries feed the MLPs; TokenSpec entries the
#: zoo models
DATA: dict[str, MixtureSpec | TokenSpec] = {
    "mixture10": MixtureSpec(n_classes=10, dim=32, sep=1.0, noise=1.2),
    "mixture10_easy": MixtureSpec(n_classes=10, dim=32),
    "mixture5_small": MixtureSpec(n_classes=5, dim=16, sep=2.5),
    "tokens_tiny": TokenSpec(vocab=512, seq=64),
}

#: lr-schedule registry: name -> factory(lr0, decay) (paper condition B.1)
SCHEDULES: dict[str, Callable] = {
    "inverse_linear": lambda lr0, decay: _schedules.inverse_linear(lr0, decay),
    "inverse_sqrt": lambda lr0, decay: _schedules.inverse_sqrt(lr0),
    "constant": lambda lr0, decay: _schedules.constant(lr0),
}

#: schedules whose factory actually consumes ``decay``
SCHEDULES_WITH_DECAY = frozenset({"inverse_linear"})

RUNNERS = ("stepwise", "fused", "netsim", "protocol", "elastic")
DELIVERIES = ("uniform", "trace")
PROTOCOL_ENGINES = ("naive", "sharded")
OPTIMIZERS = ("adamw", "sgd")
SCENARIOS = ("baseline_uniform", "heavy_tail_stragglers", "partitioned_dmc",
             "crash_storm", "byzantine_plus_slow", "membership_churn")

#: what the port does not run yet -> its ROADMAP.md item
NOT_PORTED = {
    "netsim": "the netsim runner (ROADMAP Queue 1 item 6: a port-side copy "
              "of repro.netsim)",
    "trace": "trace delivery from a netsim scenario (ROADMAP Queue 1 item 6)",
    "protocol": "the protocol runner (ROADMAP Queue 1 item 9)",
    "elastic": "the elastic runner and membership plans (ROADMAP Queue 1 "
               "item 10)",
    "zoo": "zoo architectures and token data (ROADMAP Queue 1 item 8, the "
           "model-zoo slice)",
}


@dataclass(frozen=True)
class Experiment:
    """One serializable experiment spec (the JAX package's fields)."""
    name: str = "experiment"
    # -- cluster shape + message schedule (paper Table 1 preconditions)
    n_workers: int = 9
    f_workers: int = 2
    n_servers: int = 5
    f_servers: int = 1
    q_workers: int | None = None
    q_servers: int | None = None
    T: int = 10
    variant: str = "async"            # "async" | "sync"
    # -- per-role GARs
    gar: str = "mda"
    pull_gar: str = "median"
    gather_gar: str = "median"
    worker_gar: str = "meamed"
    # -- threat model
    byz: ByzantineSpec = field(default_factory=ByzantineSpec)
    # -- delivery model
    delivery: str = "uniform"         # "uniform" | "trace"
    scenario: str | None = None       # netsim scenario name
    model_d: int | None = None        # netsim payload size override
    # -- model / data / optimizer by registry name
    model: str = "mlp_h64"
    data: str = "mixture10"
    schedule: str = "inverse_linear"
    optimizer: str = "sgd"
    lr0: float = 0.05
    decay: float = 0.005
    l2: float = 1e-4
    # -- run shape
    runner: str = "fused"
    steps: int = 150
    batch: int = 25
    seed: int = 0
    metrics_every: int = 10
    eval_n: int = 2048
    track_delta: bool = False
    # -- protocol + backend knobs
    lip_horizon: int = 128
    mda_exact_limit: int = 200_000
    agg_backend: str | None = None
    sort_network: bool = True
    epoch_steps: int | None = None
    protocol_engine: str = "sharded"
    # -- checkpointing (protocol runner)
    ckpt_every: int | None = None
    ckpt_dir: str | None = None
    # -- elastic membership (elastic runner)
    membership_plan: Any = None

    # -- construction-time validation -------------------------------------
    def __post_init__(self):
        if not isinstance(self.byz, ByzantineSpec):
            raise TypeError("byz must be a ByzantineSpec "
                            f"(got {type(self.byz).__name__})")
        kw = tuple((str(k), v) for k, v in self.byz.attack_kwargs)
        if kw != self.byz.attack_kwargs:
            object.__setattr__(self, "byz",
                               dataclasses.replace(self.byz, attack_kwargs=kw))
        if self.runner not in RUNNERS:
            raise ValueError(f"unknown runner {self.runner!r}; "
                             f"choose from {RUNNERS}")
        if self.runner in ("netsim", "protocol", "elastic"):
            raise NotImplementedError(
                f"runner={self.runner!r}: {NOT_PORTED[self.runner]} is not "
                "ported yet; the port runs 'stepwise' and 'fused'")
        if self.delivery not in DELIVERIES:
            raise ValueError(f"unknown delivery {self.delivery!r}; "
                             f"choose from {DELIVERIES}")
        if self.delivery == "trace":
            raise NotImplementedError(f"delivery='trace': {NOT_PORTED['trace']}"
                                      " is not ported yet")
        if self.membership_plan is not None:
            raise NotImplementedError(
                f"membership_plan: {NOT_PORTED['elastic']} are not ported yet")
        if self.scenario is not None and self.scenario not in SCENARIOS:
            raise ValueError(f"unknown netsim scenario {self.scenario!r}; "
                             f"have {sorted(SCENARIOS)}")
        for reg, key in ((MODELS, "model"), (DATA, "data"),
                         (SCHEDULES, "schedule")):
            val = getattr(self, key)
            if val not in reg:
                raise ValueError(f"unknown {key} {val!r}; "
                                 f"registered: {sorted(reg)}")
        if is_arch_model(self.model):
            raise ValueError(
                f"model {self.model!r} is an arch-registry model and trains "
                'through runner="protocol" only; got '
                f"{self.runner!r} ({NOT_PORTED['zoo']})")
        if isinstance(DATA[self.data], TokenSpec):
            raise ValueError(
                f"MLP model {self.model!r} needs mixture data (a MixtureSpec "
                f"DATA entry); {self.data!r} is a TokenSpec")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"registered: {sorted(OPTIMIZERS)}")
        if self.optimizer != "sgd":
            raise ValueError(
                f"optimizer={self.optimizer!r} needs the protocol/elastic "
                "runner (the single-host simulator implements the paper's "
                f"Eq. 2 SGD only); got runner={self.runner!r}")
        default_decay = type(self).__dataclass_fields__["decay"].default
        if self.schedule not in SCHEDULES_WITH_DECAY \
                and self.decay != default_decay:
            raise ValueError(
                f"schedule {self.schedule!r} ignores decay — setting "
                f"decay={self.decay} would change the spec_hash without "
                f"changing the run (leave it at the default {default_decay})")
        wa, sa = self.byz.worker_attack, self.byz.server_attack
        if wa is not None and wa not in GRADIENT_ATTACKS:
            raise ValueError(f"unknown worker_attack {wa!r}; "
                             f"have {sorted(GRADIENT_ATTACKS)}")
        if sa is not None and sa not in MODEL_ATTACKS:
            raise ValueError(f"unknown server_attack {sa!r}; "
                             f"have {sorted(MODEL_ATTACKS)}")
        for key, lo in (("steps", 1), ("batch", 1), ("metrics_every", 1),
                        ("eval_n", 1), ("T", 1)):
            if getattr(self, key) < lo:
                raise ValueError(f"{key} must be >= {lo}, "
                                 f"got {getattr(self, key)}")
        if self.agg_backend is not None:
            raise ValueError(
                f"agg_backend={self.agg_backend!r}: the port has no backend "
                "option — a CUDA stack runs its kernel, a CPU stack its plain "
                "version (repro_torch.agg.dispatch)")
        if not self.sort_network:
            raise ValueError("sort_network=False: the port has one sort (the "
                             "compare-exchange network of its kernels)")
        if self.ckpt_every is not None or self.ckpt_dir is not None:
            raise ValueError(
                "ckpt_every/ckpt_dir are protocol/elastic-runner knobs "
                f"({NOT_PORTED['protocol']}); got runner={self.runner!r}")
        if self.protocol_engine not in PROTOCOL_ENGINES:
            raise ValueError(f"unknown protocol_engine "
                             f"{self.protocol_engine!r}; "
                             f"choose from {PROTOCOL_ENGINES}")
        # the Table-1 preconditions and registry checks of the lowering
        self.to_config()

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        """Nested plain-value dict (JSON-compatible)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Experiment":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Experiment fields: {sorted(unknown)}")
        byz = d.get("byz")
        if isinstance(byz, dict):
            byz = dict(byz)
            byz["attack_kwargs"] = tuple(
                (str(k), v) for k, v in byz.get("attack_kwargs", ()))
            d["byz"] = ByzantineSpec(**byz)
        return cls(**d)

    @property
    def spec_hash(self) -> str:
        """Stable content hash: canonical JSON (sorted keys) of
        :meth:`to_dict` — the JAX package's hash for the same spec."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=list)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def replace(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)

    # -- lowering -----------------------------------------------------------
    def to_config(self) -> ByzSGDConfig:
        """Lower to the simulator's ``ByzSGDConfig`` (validated against the
        port's registry) and check that the lowering kept every field."""
        cfg = ByzSGDConfig(
            n_workers=self.n_workers, f_workers=self.f_workers,
            n_servers=self.n_servers, f_servers=self.f_servers,
            q_workers=self.q_workers, q_servers=self.q_servers, T=self.T,
            gar=self.gar, pull_gar=self.pull_gar,
            gather_gar=self.gather_gar, worker_gar=self.worker_gar,
            variant=self.variant, mda_exact_limit=self.mda_exact_limit,
            lip_horizon=self.lip_horizon, byz=self.byz)
        for key in ("n_workers", "f_workers", "n_servers", "f_servers", "T",
                    "gar", "pull_gar", "gather_gar", "worker_gar", "variant",
                    "byz"):
            if getattr(cfg, key) != getattr(self, key):
                raise ValueError(f"lowering to ByzSGDConfig changed {key}")
        for key in ("q_workers", "q_servers"):
            mine = getattr(self, key)
            if mine is not None and getattr(cfg, key) != mine:
                raise ValueError(f"lowering to ByzSGDConfig changed {key}")
        return cfg

    # -- resource construction ---------------------------------------------
    @property
    def mixture(self) -> MixtureSpec:
        return DATA[self.data]

    def build_problem(self):
        """(init_fn, loss_fn, accuracy_fn) of the named MLP on the named
        mixture."""
        if is_arch_model(self.model):
            raise NotImplementedError(f"model {self.model!r}: "
                                      f"{NOT_PORTED['zoo']}")
        mix, m = self.mixture, MODELS[self.model]
        return make_mlp_problem(dim=mix.dim, hidden=m["hidden"],
                                n_classes=mix.n_classes, depth=m["depth"],
                                l2=self.l2)

    def build_schedule(self):
        return SCHEDULES[self.schedule](self.lr0, self.decay)

    def build_sim(self, delivery=None, device=None):
        """A ready :class:`~repro_torch.core.simulator.ByzSGDSimulator` on
        ``device``."""
        from ..core.simulator import ByzSGDSimulator
        init, loss, _ = self.build_problem()
        return ByzSGDSimulator(self.to_config(), init, loss,
                               self.build_schedule(), delivery=delivery,
                               device=device)
