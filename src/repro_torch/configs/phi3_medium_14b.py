"""phi3-medium-14b [dense]: RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, rope_theta=1e4, subquadratic=False,
    notes="40 heads / kv=10 do not divide TP=16: attention activations stay "
          "data-sharded; weight shards split the fused head dim (see DESIGN).",
)
