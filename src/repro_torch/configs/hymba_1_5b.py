"""hymba-1.5b — hybrid parallel attention + Mamba heads. [arXiv:2411.13676]

Each layer runs attention heads and an SSM head in parallel on the same
input and fuses the two normalised outputs (mean fusion, per the paper).
Meta tokens are learned prefix embeddings; SWA on the attention heads
(the paper's dominant layer type — see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    vocab_size=32001,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    sliding_window=2048,
    n_meta_tokens=128,
    source="arXiv:2411.13676 (Hymba-1.5B: 32L d_model=1600 25H GQA kv=5 "
           "d_ff=5504 vocab=32001, parallel attn+mamba heads, ssm_state=16, "
           "meta tokens, SWA)",
)
