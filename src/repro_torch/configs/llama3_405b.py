"""llama3-405b — dense GQA decoder, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    vocab_size=128256,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3 405B: 126L d_model=16384 128H GQA "
           "kv=8 d_ff=53248 vocab=128256)",
)
