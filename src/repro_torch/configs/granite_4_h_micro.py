"""granite-4.0-h-micro [granite_hybrid]: Mamba2 and NoPE GQA layers in one
stack, muP multipliers. [huggingface.co/ibm-granite/granite-4.0-h-micro,
config.json; model_type granitemoehybrid]"""
from repro_torch.models.config import HybridStackConfig

#: the published ``layer_types``: attention at layers 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = HybridStackConfig(
    name="granite-4.0-h-micro", family="granite_hybrid",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=100352, head_dim=64,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    norm_eps=1e-5, tie_embeddings=True,
    layer_types=LAYER_TYPES, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=0.015625,
    logits_scaling=8.0,
    notes="40 layers: 36 Mamba2 mixers (64 heads of 64, state 128, one B/C "
          "group, conv 4 with bias) and 4 GQA mixers (32/8 heads of 64, no "
          "positional embedding), each with a SwiGLU MLP of 8192; tied "
          "vocabulary 100352.",
)
