"""qwen2-vl-7b — VLM decoder with M-RoPE. [arXiv:2409.12191]

Backbone only per spec: the ViT vision encoder + projector is a stub —
``input_specs`` provides precomputed patch embeddings (``frontend_embeds``)
plus 3-component (t,h,w) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    vocab_size=152064,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    m_rope_sections=(16, 24, 24),   # halves of head_dim/2 = 64 (t, h, w)
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    frontend_embeds=256,            # precomputed ViT patch embeds prepended
    source="arXiv:2409.12191 (Qwen2-VL-7B backbone: 28L d_model=3584 28H GQA "
           "kv=4 d_ff=18944 vocab=152064, M-RoPE, dynamic resolution)",
)
