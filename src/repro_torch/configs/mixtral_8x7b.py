"""mixtral-8x7b — 8-expert top-2 MoE with SWA. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral 8x7B: 32L d_model=4096 32H GQA kv=8 "
           "d_ff=14336 vocab=32000, 8 experts top-2, SWA 4096)",
)
