"""musicgen-medium — decoder-only LM over EnCodec tokens. [arXiv:2306.05284]

Backbone only per spec: the EnCodec/conv audio frontend is a stub —
``input_specs`` provides precomputed conditioning frame embeddings
(``frontend_embeds``). The 4-codebook delay pattern is simplified to a single
interleaved token stream over the 2048-entry codebook (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    vocab_size=2048,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    frontend="audio_frames",
    frontend_embeds=64,         # conditioning frames prepended as embeds
    source="arXiv:2306.05284 (MusicGen-medium backbone: 48L d_model=1536 "
           "24H kv=24 d_ff=6144 vocab=2048 over EnCodec tokens)",
)
