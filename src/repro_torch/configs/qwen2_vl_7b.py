"""qwen2-vl-7b [vlm]: M-RoPE, dynamic resolution (frontend stubbed).
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, mrope=True, rope_theta=1e6, subquadratic=False,
    notes="Backbone only: input_specs provides merged patch/text embeddings "
          "[B,S,D] + 3-component M-RoPE position ids (vision frontend = stub).",
)
