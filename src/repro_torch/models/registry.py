"""Architecture registry: ``get_bundle(arch_id)`` -> :class:`ModelBundle`.

Bundle methods, as in ``repro.models.registry``:
    init(gen, dtype) -> params                  (on ``gen.device``)
    loss(params, batch) -> scalar               (the train step's inner fn)
    prefill(params, batch, caches) -> (logits, caches)
    decode(params, caches, batch) -> (logits, caches)
    init_caches(batch, max_len, n_chunks, device=...) -> caches
    make_batch(kind, B, S, gen) -> concrete batch
and what the serving loop uses in place of the JAX ``vmap`` over replicas
and slots:
    prefill_replicas(reps, tokens, caches) -> logits [R, B, V]
    decode_replicas(reps, caches, tokens) -> logits [R, B, V]
    cache_rows(caches, rows) -> views of batch rows ``rows`` (a slot)
    reset_cache_rows(caches, rows) -> those rows ready for a new request

Families ported: ``dense`` (``transformer.py``: phi4-mini-3.8b,
h2o-danube-3-4b, phi3-medium-14b, internlm2-20b), ``moe`` (``moe.py``:
qwen3-moe-235b-a22b, dbrx-132b) and ``ssm`` (``rwkv6.py``: rwkv6-3b).
``ARCH_IDS`` lists every arch of the reference; the others (qwen2-vl-7b,
zamba2-1.2b, whisper-small) raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from .config import ArchConfig

ARCH_IDS = [
    "dbrx-132b", "qwen3-moe-235b-a22b", "zamba2-1.2b", "h2o-danube-3-4b",
    "phi3-medium-14b", "phi4-mini-3.8b", "internlm2-20b", "rwkv6-3b",
    "qwen2-vl-7b", "whisper-small",
]

_CONFIG_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

#: the arch ids the port runs, in ``ARCH_IDS`` order
PORTED_IDS = [a for a in ARCH_IDS if a in _CONFIG_MODULES]

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.rwkv6",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    if arch_id not in _CONFIG_MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md, queue 1 item "
            f"8: the models zoo); have {PORTED_IDS}")
    return importlib.import_module(_CONFIG_MODULES[arch_id]).CONFIG


@dataclass
class ModelBundle:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILY_MODULES:
            raise NotImplementedError(
                f"model family {self.cfg.family!r} ({self.cfg.name}) is not "
                "ported yet (ROADMAP.md, queue 1 item 8)")
        self.mod = importlib.import_module(_FAMILY_MODULES[self.cfg.family])

    # -- core fns ----------------------------------------------------------
    def init(self, gen: torch.Generator, dtype=torch.float32):
        return self.mod.init(gen, self.cfg, dtype)

    def loss(self, params, batch):
        return self.mod.loss(params, batch, cfg=self.cfg)

    def prefill(self, params, batch, caches):
        return self.mod.prefill(params, batch, caches, cfg=self.cfg)

    def decode(self, params, caches, batch):
        return self.mod.decode_step(params, caches, batch, cfg=self.cfg)

    def prefill_replicas(self, reps, tokens, caches):
        return self.mod.prefill_replicas(reps, tokens, caches, cfg=self.cfg)

    def decode_replicas(self, reps, caches, tokens):
        return self.mod.decode_replicas(reps, caches, tokens, cfg=self.cfg)

    def init_caches(self, batch: int, max_len: int, n_chunks: int = 16,
                    dtype=torch.bfloat16, device=None):
        return self.mod.init_caches(self.cfg, batch, max_len, n_chunks, dtype,
                                    device)

    def cache_rows(self, caches, rows: slice):
        return self.mod.cache_rows(caches, rows)

    def reset_cache_rows(self, caches, rows: slice):
        return self.mod.reset_cache_rows(caches, rows)

    # -- batch construction --------------------------------------------------
    def make_batch(self, kind: str, B: int, S: int,
                   gen: torch.Generator) -> dict:
        """Concrete random token batch (smoke tests, the launch driver)."""
        if kind in ("train", "prefill"):
            shape = {"tokens": (B, S), "labels": (B, S)}
        elif kind == "decode":
            shape = {"token": (B, 1)}
        else:
            raise ValueError(kind)
        return {name: torch.randint(0, self.cfg.vocab, s, generator=gen,
                                    device=gen.device)
                for name, s in sorted(shape.items())}


def get_bundle(arch_id: str, reduced: bool = False, depth: int | None = None,
               **overrides) -> ModelBundle:
    """``reduced``: the smoke-test sibling (``ArchConfig.reduced``, which
    takes ``overrides``). ``depth``: override ``n_layers`` only (everything
    else stays as configured; the encoder depth of enc-dec archs with it)."""
    import dataclasses
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced(**overrides)
    if depth is not None:
        upd = {"n_layers": depth}
        if cfg.encoder_layers:
            upd["encoder_layers"] = depth
        cfg = dataclasses.replace(cfg, **upd)
    return ModelBundle(cfg)
