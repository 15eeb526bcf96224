"""The :class:`Experiment` spec of ``repro.exp.spec`` — one frozen,
fully serializable object that names a ByzSGD experiment.

Same fields, defaults, normalisations, ``to_dict``/``from_dict`` and
``spec_hash`` as the JAX package, so one preset hashes alike in both. The
delivery is ``"uniform"`` (Assumption 7) or ``"trace"`` (a realized
:mod:`repro_torch.netsim` schedule of the named ``scenario``, for every
runner here); ``runner="netsim"`` is the fused runner over the trace, and
forces ``delivery="trace"``. ``Experiment`` lowers to the internal carriers
— :meth:`to_config` (``ByzSGDConfig``), :meth:`to_protocol_config` and
:meth:`to_scenario` (netsim ``Scenario``) — and each lowering checks that
it kept every shared field.

Every runner of the JAX package runs here, ``elastic`` (with its
``membership_plan``) included, and every registered preset runs; backend
options fail at construction (the port has one sort and no backend
switch).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Callable

from ..configs.paper_models import make_mlp_problem
from ..core.attacks import GRADIENT_ATTACKS, MODEL_ATTACKS, ByzantineSpec
from ..core.membership import MembershipPlan, epoch_config
from ..core.simulator import ByzSGDConfig
from ..data.pipeline import MixtureSpec, TokenSpec
from .. import optim as _optim
from ..optim import schedules as _schedules

# ---------------------------------------------------------------------------
# named resources: models / data / lr schedules (copies of the JAX registry)
# ---------------------------------------------------------------------------

#: model registry. ``{"hidden", "depth"}`` entries are MLPs, trainable by
#: every runner; ``{"arch", "reduced", ...overrides}`` entries are zoo
#: architectures (lowered by ``models.registry.get_bundle``), which train
#: through ``runner="protocol"`` only (the dense transformer, MoE and
#: RWKV6 families).
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
    # -- checkpointing (protocol and elastic runners): the replica-stacked
    # ByzState every ckpt_every steps into ckpt_dir (presets leave ckpt_dir
    # to the caller)
    ckpt_every: int | None = None
    ckpt_dir: str | None = None
    # -- elastic membership (elastic runner): None means the named netsim
    # scenario's realized crash windows, or a static fleet
    membership_plan: MembershipPlan | None = None

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
        if self.delivery not in DELIVERIES:
            raise ValueError(f"unknown delivery {self.delivery!r}; "
                             f"choose from {DELIVERIES}")
        if self.runner == "netsim" and self.delivery != "trace":
            object.__setattr__(self, "delivery", "trace")
        if self.membership_plan is not None:
            mp = self.membership_plan
            if isinstance(mp, dict):
                mp = MembershipPlan.from_dict(mp)
                object.__setattr__(self, "membership_plan", mp)
            if not isinstance(mp, MembershipPlan):
                raise TypeError("membership_plan must be a MembershipPlan "
                                f"(got {type(mp).__name__})")
            if self.runner != "elastic":
                raise ValueError(
                    'membership_plan is a runner="elastic" knob (only the '
                    "elastic runner re-forms the fleet at membership "
                    f"boundaries); got runner={self.runner!r}")
        if self.runner == "elastic" and self.delivery == "trace":
            raise ValueError(
                'runner="elastic" needs delivery="uniform": trace delivery '
                "tables are staged at the launch fleet width and cannot "
                "follow a membership change (a scenario still drives the "
                'elastic run — its realized crash windows become the '
                "membership plan)")
        if self.delivery == "trace" and self.scenario is None:
            raise ValueError('delivery="trace" needs a netsim scenario '
                             "name (Experiment.scenario)")
        if self.scenario is not None:
            from ..netsim import scenarios as _scen
            if self.scenario not in _scen.SCENARIOS:
                raise ValueError(f"unknown netsim scenario {self.scenario!r}; "
                                 f"have {sorted(_scen.SCENARIOS)}")
        for reg, key in ((MODELS, "model"), (DATA, "data"),
                         (SCHEDULES, "schedule")):
            val = getattr(self, key)
            if val not in reg:
                raise ValueError(f"unknown {key} {val!r}; "
                                 f"registered: {sorted(reg)}")
        if is_arch_model(self.model):
            if self.runner != "protocol":
                raise ValueError(
                    f"model {self.model!r} is an arch-registry model and "
                    'trains through runner="protocol" only (token batches '
                    "and replica-stacked model states are protocol-engine "
                    f"capabilities); got {self.runner!r}")
            if not isinstance(DATA[self.data], TokenSpec):
                raise ValueError(
                    f"arch model {self.model!r} needs token data (a TokenSpec "
                    f"DATA entry); {self.data!r} is "
                    f"{type(DATA[self.data]).__name__}")
            vocab = self.arch_config().vocab
            if DATA[self.data].vocab != vocab:
                raise ValueError(
                    f"data {self.data!r} has vocab {DATA[self.data].vocab} "
                    f"but model {self.model!r} has vocab {vocab}")
        elif isinstance(DATA[self.data], TokenSpec):
            raise ValueError(
                f"MLP model {self.model!r} needs mixture data (a MixtureSpec "
                f"DATA entry); {self.data!r} is a TokenSpec")
        if self.optimizer not in _optim.OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"registered: {sorted(_optim.OPTIMIZERS)}")
        if self.optimizer != "sgd" and self.runner not in ("protocol",
                                                           "elastic"):
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
        if self.ckpt_every is not None:
            if self.runner not in ("protocol", "elastic"):
                raise ValueError(
                    'ckpt_every is a runner="protocol"/"elastic" knob (those '
                    "engines own the replica-stacked ByzState that "
                    f"checkpoints save); got runner={self.runner!r}")
            if self.ckpt_every < 1:
                raise ValueError(f"ckpt_every must be >= 1, "
                                 f"got {self.ckpt_every}")
        elif self.ckpt_dir is not None and self.runner != "elastic":
            # the elastic runner reads ckpt_dir alone: it resumes from the
            # latest checkpoint and saves at every membership boundary and
            # at the end
            raise ValueError("ckpt_dir without ckpt_every does nothing; "
                             "set ckpt_every to emit checkpoints")
        if self.protocol_engine not in PROTOCOL_ENGINES:
            raise ValueError(f"unknown protocol_engine "
                             f"{self.protocol_engine!r}; "
                             f"choose from {PROTOCOL_ENGINES}")
        # the Table-1 preconditions and registry checks of the lowering
        self.to_config()
        if self.runner in ("protocol", "elastic"):
            pcfg = self.to_protocol_config()
            if self.runner == "elastic" and self.membership_plan is not None:
                # every epoch of the plan meets Table 1 for its fleet: a
                # below-floor plan fails here, not mid-run
                for seg in self.membership_plan.epochs(self.n_workers,
                                                       self.steps):
                    epoch_config(pcfg, seg.active,
                                 synchronous=(self.variant == "sync"))

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
        mp = d.get("membership_plan")
        if isinstance(mp, dict):
            d["membership_plan"] = MembershipPlan.from_dict(mp)
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

    def to_protocol_config(self):
        """Lower to :class:`~repro_torch.core.protocol.ProtocolConfig`
        (``runner="protocol"``), cross-validated like :meth:`to_config`: G
        co-located worker+server groups need ``n_workers == n_servers``;
        the quorums come from the ``ByzSGDConfig`` lowering, and the
        ``variant`` picks the pull (async: masked ``pull_gar``; sync: the
        protocol's §5 round-robin pull with its distance filter, not the
        single-host sync filter variant)."""
        from ..core.protocol import ProtocolConfig
        if self.n_workers != self.n_servers:
            raise ValueError(
                f'runner="protocol" maps co-located worker+server groups '
                f"onto failure domains and needs n_workers == n_servers "
                f"(= G); got {self.n_workers} != {self.n_servers}")
        cfg = self.to_config()
        pcfg = ProtocolConfig.derive(
            self.n_workers, T=self.T, engine=self.protocol_engine,
            pull=("roundrobin" if self.variant == "sync" else "median"),
            f_workers=self.f_workers, f_servers=self.f_servers,
            q_workers=cfg.q_workers, q_servers=cfg.q_servers,
            gar=self.gar, pull_gar=self.pull_gar,
            gather_gar=self.gather_gar, optimizer=self.optimizer,
            mda_exact_limit=self.mda_exact_limit, byz=self.byz)
        for key, mine in (("n_groups", self.n_workers),
                          ("f_workers", self.f_workers),
                          ("f_servers", self.f_servers),
                          ("q_workers", cfg.q_workers),
                          ("q_servers", cfg.q_servers), ("T", self.T),
                          ("gar", self.gar), ("pull_gar", self.pull_gar),
                          ("gather_gar", self.gather_gar),
                          ("optimizer", self.optimizer),
                          ("byz", self.byz)):
            if getattr(pcfg, key) != mine:
                raise ValueError(f"lowering to ProtocolConfig changed {key}: "
                                 f"{mine!r} -> {getattr(pcfg, key)!r}")
        return pcfg

    def to_scenario(self, **overrides):
        """Lower to the netsim ``Scenario`` (via its factory registry),
        cross-validated: shape, schedule, GAR and threat-model fields must
        survive the factory unchanged. ``overrides`` are forwarded to the
        factory (e.g. ``model_d=…`` for payload sizing)."""
        from ..netsim import scenarios as _scen
        if self.scenario is None:
            raise ValueError(f"experiment {self.name!r} names no netsim "
                             "scenario")
        kw = dict(n_workers=self.n_workers, f_workers=self.f_workers,
                  n_servers=self.n_servers, f_servers=self.f_servers,
                  q_workers=self.q_workers, q_servers=self.q_servers,
                  T=self.T, steps=self.steps, seed=self.seed, gar=self.gar,
                  variant=self.variant,
                  worker_attack=self.byz.worker_attack,
                  server_attack=self.byz.server_attack,
                  n_byz_workers=self.byz.n_byz_workers,
                  n_byz_servers=self.byz.n_byz_servers)
        if self.model_d is not None:
            kw["model_d"] = self.model_d
        kw.update(overrides)
        sc = _scen.build(self.scenario, **kw)
        for key in ("n_workers", "f_workers", "n_servers", "f_servers", "T",
                    "gar", "variant", "worker_attack", "server_attack",
                    "n_byz_workers", "n_byz_servers"):
            if getattr(sc, key) != kw[key]:
                raise ValueError(f"lowering to Scenario changed {key}: "
                                 f"{kw[key]!r} -> {getattr(sc, key)!r}")
        return sc

    # -- resource construction ---------------------------------------------
    @property
    def mixture(self) -> MixtureSpec:
        return DATA[self.data]

    def arch_config(self):
        """The named zoo arch's ``ArchConfig`` (registry overrides applied
        on the reduced config), without building its model."""
        from ..models.registry import get_config
        m = MODELS[self.model]
        cfg = get_config(m["arch"])
        if m.get("reduced"):
            cfg = cfg.reduced(**{k: v for k, v in m.items()
                                 if k not in ("arch", "reduced")})
        return cfg

    def build_problem(self):
        """(init_fn, loss_fn, accuracy_fn) of the named MLP on the named
        mixture (arch models lower via :meth:`build_bundle`)."""
        if is_arch_model(self.model):
            raise ValueError(
                f"model {self.model!r} is an arch-registry model; it lowers "
                "through build_bundle() (a ModelBundle), not the MLP "
                "(init, loss, acc) problem triple")
        mix, m = self.mixture, MODELS[self.model]
        return make_mlp_problem(dim=mix.dim, hidden=m["hidden"],
                                n_classes=mix.n_classes, depth=m["depth"],
                                l2=self.l2)

    def build_bundle(self):
        """The protocol-ready bundle of the named model: the zoo
        :class:`~repro_torch.models.registry.ModelBundle` for arch entries,
        or the MLP problem wrapped in
        a :class:`~repro_torch.core.protocol.ProblemBundle`."""
        m = MODELS[self.model]
        if "arch" in m:
            from ..models.registry import get_bundle
            kw = {k: v for k, v in m.items() if k not in ("arch", "reduced")}
            return get_bundle(m["arch"], reduced=m.get("reduced", False),
                              **kw)
        from ..core.protocol import ProblemBundle
        init, loss, _ = self.build_problem()
        return ProblemBundle(init=init, loss=loss)

    def build_schedule(self):
        return SCHEDULES[self.schedule](self.lr0, self.decay)

    def build_sim(self, delivery=None, device=None):
        """A ready :class:`~repro_torch.core.simulator.ByzSGDSimulator` on
        ``device`` (delivery defaults to ``UniformDelivery``; pass a
        ``TraceDelivery`` for trace-driven runs)."""
        from ..core.simulator import ByzSGDSimulator
        init, loss, _ = self.build_problem()
        return ByzSGDSimulator(self.to_config(), init, loss,
                               self.build_schedule(), delivery=delivery,
                               device=device)
