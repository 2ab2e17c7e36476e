"""h2o-danube-3-4b — dense llama/mistral mix with SWA. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    vocab_size=32000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    sliding_window=4096,
    source="arXiv:2401.16818 (H2O-Danube3-4B: 24L d_model=3840 32H GQA kv=8 "
           "d_ff=10240 vocab=32000, llama+mistral mix, SWA)",
)
