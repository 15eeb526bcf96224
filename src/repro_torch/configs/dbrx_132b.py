"""dbrx-132b [moe]: 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, n_experts=16, top_k=4,
    rope_theta=5e5, subquadratic=False,
    byz_group_divisor=4, param_dtype="bfloat16",
    notes="Layout B (n_ps=4, K=4) on the single-pod mesh; EP over 'model'.",
)
