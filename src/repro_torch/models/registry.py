"""Architecture registry: ``get_bundle(arch_id)`` -> :class:`ModelBundle`.

Bundle methods, as in ``repro.models.registry``:
    init(gen, dtype) -> params                  (on ``gen.device``)
    loss(params, batch) -> scalar               (the train step's inner fn)
    prefill(params, batch, caches) -> (logits, caches)
    decode(params, caches, batch) -> (logits, caches)
    init_caches(batch, max_len, n_chunks, device=...) -> caches
    make_batch(kind, B, S, gen) -> concrete batch
    batch_specs(kind, B, S) -> meta stand-ins of every input
    supports_cell(shape_name) -> (ok, why)
    meta_params(dtype) -> the params' shapes as meta tensors
and what the serving loop uses in place of the JAX ``vmap`` over replicas
and slots:
    prefill_replicas(reps, tokens, caches) -> logits [R, B, V]
    decode_replicas(reps, caches, tokens) -> logits [R, B, V]
    cache_rows(caches, rows) -> views of batch rows ``rows`` (a slot)
    reset_cache_rows(caches, rows) -> those rows ready for a new request

Every family of the reference is ported: ``dense`` (``transformer.py``:
phi4-mini-3.8b, h2o-danube-3-4b, phi3-medium-14b, internlm2-20b), ``vlm``
(``transformer.py`` with merged embeddings and M-RoPE positions:
qwen2-vl-7b), ``moe`` (``moe.py``: qwen3-moe-235b-a22b, dbrx-132b),
``ssm`` (``rwkv6.py``: rwkv6-3b), ``hybrid`` (``hybrid.py`` over
``mamba2.py``: zamba2-1.2b) and ``audio`` (``encdec.py``: whisper-small).
The port adds a family of its own, ``granite_hybrid``
(``granite_hybrid.py`` over ``mamba2.py``: granite-4.0-h-micro), under
an id of :data:`PORT_ONLY_IDS`. The serving loop's replica forms exist
for the token-in families; ``vlm`` and ``audio`` are served by
``prefill`` and ``decode`` only, as in the reference.
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
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "granite-4.0-h-micro": "repro_torch.configs.granite_4_h_micro",
}

#: the arch ids the port runs, in ``ARCH_IDS`` order (all of them)
PORTED_IDS = [a for a in ARCH_IDS if a in _CONFIG_MODULES]

#: the arch ids of the port alone (no config of the JAX package's)
PORT_ONLY_IDS = ["granite-4.0-h-micro"]

#: every arch id ``get_config``, ``get_bundle`` and the launchers take
ALL_IDS = ARCH_IDS + PORT_ONLY_IDS

#: the families whose layers take the 'model' axis (tensor parallelism,
#: ``repro_torch.models.sharding``): every family of the reference's zoo
MODEL_AXIS_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")


def check_model_axis(cfg, M: int) -> None:
    """Refuse a 'model' axis of M > 1 ranks for a model that has no
    tensor-parallel layers. The axis runs the families of
    :data:`MODEL_AXIS_FAMILIES` and the paper's MLP problem (a
    :class:`~repro_torch.core.protocol.ProblemBundle`'s config: the split
    form of :mod:`repro_torch.configs.paper_models`)."""
    fam = getattr(cfg, "family", None)
    if M <= 1 or fam in MODEL_AXIS_FAMILIES:
        return
    from ..core.protocol import _ProblemCfg
    if not isinstance(cfg, _ProblemCfg):
        raise NotImplementedError(
            f"model = {M} for {getattr(cfg, 'name', 'this model')} (family "
            f"{fam!r}): it has no tensor-parallel layers; the 'model' axis "
            f"runs the families {MODEL_AXIS_FAMILIES} and the paper's MLP "
            "problem (protocol.ProblemBundle of "
            "configs.paper_models.make_mlp_problem)")

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "vlm": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "hybrid": "repro_torch.models.hybrid",
    "ssm": "repro_torch.models.rwkv6",
    "audio": "repro_torch.models.encdec",
    "granite_hybrid": "repro_torch.models.granite_hybrid",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _CONFIG_MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; have {ALL_IDS}")
    return importlib.import_module(_CONFIG_MODULES[arch_id]).CONFIG


@dataclass
class ModelBundle:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILY_MODULES:
            raise ValueError(f"unknown model family {self.cfg.family!r} "
                             f"({self.cfg.name}); have "
                             f"{sorted(_FAMILY_MODULES)}")
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
    def batch_specs(self, kind: str, B: int, S: int) -> dict:
        """Shape-only stand-ins (``meta`` tensors) of every model input, as
        the reference's ``batch_specs`` (int32 ids, bf16 embeddings): tokens
        and labels ``[B, S]``; for ``vlm`` ``embeds [B, S, D]`` and M-RoPE
        ``positions [3, B, S]``; for ``audio`` ``enc_frames [B, S/2, D]``
        and ``S/2`` tokens; decode one token (one embedding) a row."""
        fam, D = self.cfg.family, self.cfg.d_model
        if kind in ("train", "prefill"):
            if fam == "vlm":
                shape = {"embeds": (B, S, D), "positions": (3, B, S),
                         "labels": (B, S)}
            elif fam == "audio":
                shape = {"enc_frames": (B, S // 2, D), "tokens": (B, S // 2),
                         "labels": (B, S // 2)}
            else:
                shape = {"tokens": (B, S), "labels": (B, S)}
        elif kind == "decode":
            shape = ({"embeds": (B, 1, D), "positions": (3, B, 1)}
                     if fam == "vlm" else {"token": (B, 1)})
        else:
            raise ValueError(kind)
        return {name: torch.empty(s, device="meta", dtype=(
            torch.bfloat16 if name in ("embeds", "enc_frames")
            else torch.int32)) for name, s in shape.items()}

    def make_batch(self, kind: str, B: int, S: int,
                   gen: torch.Generator) -> dict:
        """Concrete random batch of every model input (smoke tests, the
        launch drivers) in :meth:`batch_specs`' shapes: bf16 ``embeds`` and
        ``enc_frames`` (``0.02 * normal``), ids in ``[0, vocab)`` and
        ``positions`` in ``[0, max(S, 2))`` as int64 (torch's index
        dtype). Drawn from ``gen``, in name order."""
        out = {}
        for name, spec in sorted(self.batch_specs(kind, B, S).items()):
            s = tuple(spec.shape)
            if name in ("embeds", "enc_frames"):
                out[name] = (0.02 * torch.randn(
                    s, generator=gen, device=gen.device)).bfloat16()
            else:
                hi = self.cfg.vocab if name != "positions" else max(S, 2)
                out[name] = torch.randint(0, hi, s, generator=gen,
                                          device=gen.device)
        return out

    def meta_params(self, dtype=torch.float32) -> dict:
        """The model's params as ``meta`` tensors in ``dtype``: the
        family's own init run under a fake-tensor mode, so nothing is
        drawn or allocated (the dry run's shapes)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            fake = self.init(torch.Generator(), dtype)

        def meta(node):
            if isinstance(node, dict):
                return {k: meta(v) for k, v in node.items()}
            return torch.empty(node.shape, dtype=node.dtype, device="meta")

        return meta(fake)

    # -- shape-cell helpers ----------------------------------------------------
    def supports_cell(self, shape_name: str) -> tuple[bool, str]:
        """The reference's skips: a ``long_*`` cell needs sub-quadratic
        serving."""
        if shape_name.startswith("long_") and not self.cfg.subquadratic:
            return False, ("full quadratic attention: 500k-context serve_step "
                           "skipped per assignment (see DESIGN.md)")
        return True, ""


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
