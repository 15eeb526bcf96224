"""Architecture registry: ``get_bundle(arch_id)`` -> :class:`ModelBundle`.

Bundle methods, as in ``repro.models.registry``:
    init(gen, dtype) -> params                  (on ``gen.device``)
    loss(params, batch) -> scalar               (the train step's inner fn)
    prefill(params, batch, caches) -> (logits, caches)
    decode(params, caches, batch) -> (logits, caches)
    init_caches(batch, max_len, n_chunks, device=...) -> caches
    make_batch(kind, B, S, gen) -> concrete batch
and the replica-batched forms the serving loop uses in place of the JAX
``vmap`` over replicas:
    prefill_replicas(reps, tokens, caches) -> logits [R, B, V]
    decode_replicas(reps, caches, tokens) -> logits [R, B, V]

Only the ``dense`` family is ported so far; the configs of the MoE and RWKV6
archs of the experiment registry are here, their families are not.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from .config import ArchConfig

_CONFIG_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    # configs only: their families (moe, ssm) wait for the zoo port
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _CONFIG_MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md, queue 1: "
            f"modules to port); have {sorted(_CONFIG_MODULES)}")
    return importlib.import_module(_CONFIG_MODULES[arch_id]).CONFIG


@dataclass
class ModelBundle:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILY_MODULES:
            raise NotImplementedError(
                f"model family {self.cfg.family!r} ({self.cfg.name}) needs "
                "the zoo port (ROADMAP Queue 1 item 8)")
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
