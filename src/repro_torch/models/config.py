"""Architecture configuration schema (one instance per assigned arch)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / rwkv6 blocks)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid (zamba2): apply the shared attention block every k ssm layers
    shared_attn_every: int = 0
    shared_attn_heads: int = 0
    shared_attn_d_ff: int = 0
    # attention details
    sliding_window: int = 0      # SWA (h2o-danube)
    rope_theta: float = 1e6
    mrope: bool = False          # qwen2-vl
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    max_source_len: int = 0
    # norm & misc
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act_dtype: str = "bfloat16"
    # attention blocking (memory envelope of prefill/train)
    q_block: int = 512
    kv_block: int = 1024
    # long-context capability: True iff serve_step cost is sub-quadratic in ctx
    subquadratic: bool = False
    # ByzSGD group policy: n_groups = R // byz_group_divisor (failure domains;
    # >1 for archs whose per-replica memory forces fewer, larger server groups)
    byz_group_divisor: int = 1
    # hard cap on n_groups (0 = none). qwen3 multi-pod: the XLA SPMD
    # partitioner SIGFPEs at G=4/K=8 (b/433785288); G=2 compiles. The
    # intended config is G=4 — revisit on a Shardy toolchain.
    byz_group_cap: int = 0
    # replica storage dtype: f32 (paper-faithful SGD) unless replica memory
    # forces bf16 (dbrx/qwen3 — documented deviation, DESIGN.md)
    param_dtype: str = "float32"
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test-sized sibling: same family/topology, tiny dims."""
        import dataclasses
        small = dict(
            n_layers=min(self.n_layers, 2 if self.shared_attn_every == 0
                         else self.shared_attn_every + 1),
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256, vocab=512, head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            shared_attn_every=min(self.shared_attn_every, 2) if self.shared_attn_every else 0,
            shared_attn_heads=4 if self.shared_attn_every else 0,
            shared_attn_d_ff=256 if self.shared_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            max_source_len=min(self.max_source_len, 64) if self.max_source_len else 0,
            q_block=64, kv_block=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class HybridStackConfig(ArchConfig):
    """A stack whose layers each hold one mixer, named by ``layer_types``
    (``"mamba"``: a Mamba2 mixer on the ``ssm_*`` sizes; ``"attention"``:
    GQA with no positional embedding), each followed by a SwiGLU MLP of
    ``d_ff``, with the muP multipliers of Granite 4.0-H: the embedding
    times ``embedding_multiplier``, each residual branch times
    ``residual_multiplier``, the softmax scale ``attention_multiplier``
    (None: ``1/sqrt(hd)``), the logits over ``logits_scaling``. The layers
    are ``layer_types[:n_layers]``. A port-only schema: the JAX package
    has no such family."""
    layer_types: tuple = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float | None = None
    logits_scaling: float = 1.0

    def reduced(self, **overrides) -> "HybridStackConfig":
        """The smoke-test sibling: :meth:`ArchConfig.reduced`'s widths over
        three layers, Mamba2, attention, Mamba2, so both mixers run."""
        small = dict(n_layers=3, layer_types=("mamba", "attention", "mamba"))
        small.update(overrides)
        return super().reduced(**small)
