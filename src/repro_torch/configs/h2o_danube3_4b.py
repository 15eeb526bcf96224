"""h2o-danube-3-4b [dense]: llama+mistral mix, SWA. [arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab=32000, sliding_window=4096, rope_theta=5e5,
    subquadratic=True,
    notes="SWA window 4096 (mistral-style; source does not pin the width - "
          "documented choice). long_500k decode runs: windowed cache is O(4k).",
)
