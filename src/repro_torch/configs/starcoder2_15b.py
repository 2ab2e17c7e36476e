"""starcoder2-15b — dense GQA + RoPE code model. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    vocab_size=49152,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    rope_theta=100_000.0,
    source="arXiv:2402.19173 (StarCoder2-15B: 40L d_model=6144 48H GQA kv=4 "
           "d_ff=24576 vocab=49152, RoPE)",
)
