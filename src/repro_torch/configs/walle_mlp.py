"""walle-mlp — the paper's own policy model (port of
``repro/configs/walle_mlp.py``).

WALL-E's experiments (MuJoCo HalfCheetah-v2, PPO) use a small Gaussian-MLP
policy + value network: ``models/mlp_policy.py`` with 2 hidden layers of
width 64, the RL algorithms' default model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="walle-mlp",
    family="mlp",
    n_layers=2,          # hidden layers
    d_model=64,          # hidden width
    vocab_size=0,
    source="WALL-E (2019) §4: PPO Gaussian-MLP policy on HalfCheetah-v2",
)
