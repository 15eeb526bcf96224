"""whisper-small [audio]: enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, encoder_layers=12, max_source_len=1500,
    norm="layernorm", tie_embeddings=True, subquadratic=False,
    notes="Frame embeddings [B,Se,D] are the stub frontend output. train_4k = "
          "2048 encoder frames + 2048 decoder tokens (seq split, documented).",
)
