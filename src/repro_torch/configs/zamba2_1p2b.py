"""zamba2-1.2b [hybrid]: Mamba2 + shared attn blocks. [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, shared_attn_heads=32, shared_attn_d_ff=8192,
    subquadratic=True,
    notes="38 Mamba2 layers; ONE shared MHA+MLP block applied after every 6th "
          "layer (6 sites, per-site KV cache). long_500k runs (O(1) SSM state).",
)
