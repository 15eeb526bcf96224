"""qwen3-moe-235b-a22b [moe]: 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, n_experts=128, top_k=8,
    rope_theta=1e6, subquadratic=False,
    byz_group_divisor=8, byz_group_cap=2, param_dtype="bfloat16",
    notes="Layout B (n_ps=2, K=8) single-pod; fine-grained EP (8 experts/chip).",
)
