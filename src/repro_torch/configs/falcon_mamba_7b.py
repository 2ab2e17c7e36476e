"""falcon-mamba-7b — pure Mamba1 (attention-free) LM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    vocab_size=65024,
    d_ff=0,
    n_heads=0,
    n_kv_heads=0,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2410.05355 (Falcon Mamba: 64L d_model=4096 mamba1, "
           "state=16, vocab=65024)",
)
