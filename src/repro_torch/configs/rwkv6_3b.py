"""rwkv6-3b [ssm]: Finch, data-dependent decay, attn-free. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, ssm_head_dim=64, subquadratic=True,
    notes="Attention-free; n_heads is derived (2560/64). long_500k runs "
          "(O(1) WKV state decode).",
)
