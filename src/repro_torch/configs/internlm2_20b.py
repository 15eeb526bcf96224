"""internlm2-20b [dense]: GQA. [arXiv:2403.17297; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, rope_theta=1e6, subquadratic=False,
    byz_group_divisor=2,
    notes="G=R/2 server groups: 16 full 20B fp32 replicas exceed v5e HBM; "
          "8 groups (f_w=f_ps=2) fit — the resilience-memory tradeoff "
          "(DESIGN.md §Worker granularity).",
)
