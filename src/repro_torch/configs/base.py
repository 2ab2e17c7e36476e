"""Model / run configuration dataclasses (a copy of
``repro/configs/base.py``: the port imports nothing of ``repro``).

Every assigned architecture gets one ``<arch>.py`` in this package exporting
``CONFIG`` (the exact published configuration, cited) plus the registry here.
``ModelConfig.reduced()`` derives the CPU smoke-test variant (<=2 layers,
d_model <= 512, <= 4 experts) of the *same family* per the repro spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "mlp")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    n_heads: int = 0                    # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 0                   # 0 => d_model // n_heads
    d_ff: int = 0                       # 0 => no MLP block (pure SSM)
    rope_theta: float = 10_000.0
    qkv_bias: bool = False              # Qwen1.5-style QKV bias
    sliding_window: int = 0             # 0 => full causal attention
    m_rope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (t, h, w) halves
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (Mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0                # 0 => ceil(d_model / 16)
    # --- hybrid (Hymba) ---
    n_meta_tokens: int = 0              # learned prefix tokens
    # --- modality frontend stub ---
    frontend: str = "none"              # none | audio_frames | vision_patches
    frontend_embeds: int = 0            # number of precomputed embeds supplied
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                    # citation for the configuration

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.is_ssm and self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank",
                               math.ceil(self.d_model / 16))
        if self.m_rope_sections:
            assert sum(self.m_rope_sections) == self.head_dim // 2, (
                "M-RoPE sections must sum to head_dim/2")

    # ------------------------------------------------------------------ #
    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used for 6*N*D)."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        total = v * d                                    # embed
        if not self.tie_embeddings:
            total += d * v                               # lm head
        total += d                                       # final norm
        per_layer = 0
        if self.has_attention:
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            per_layer += d * qd + 2 * d * kvd + qd * d   # wq wk wv wo
            if self.qkv_bias:
                per_layer += qd + 2 * kvd
            per_layer += d                               # attn norm
        if self.d_ff:
            ff = 3 * d * self.d_ff                       # SwiGLU w1 w3 w2
            if self.is_moe:
                per_layer += self.n_experts * ff + d * self.n_experts  # router
            else:
                per_layer += ff
            per_layer += d                               # mlp norm
        if self.is_ssm:
            di, st, dtr = self.d_inner, self.ssm_state, self.ssm_dt_rank
            per_layer += d * 2 * di                      # in_proj
            per_layer += di * self.ssm_conv + di         # conv w + b
            per_layer += di * (dtr + 2 * st)             # x_proj
            per_layer += dtr * di + di                   # dt_proj + bias
            per_layer += di * st + di                    # A_log, D
            per_layer += di * d                          # out_proj
            if self.family == "ssm":
                per_layer += d                           # ssm norm
        if self.family == "hybrid":
            per_layer += 2 * d                           # fusion norms
        total += per_layer * L
        total += self.n_meta_tokens * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if not self.is_moe:
            return self.param_count()
        ff = 3 * self.d_model * self.d_ff
        inactive = (self.n_experts - self.top_k) * ff * self.n_layers
        return self.param_count() - inactive

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims, CPU-runnable."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = 0
        if self.n_kv_heads:
            # preserve the GQA ratio class: MHA stays MHA, GQA stays grouped
            n_kv = n_heads if self.n_kv_heads == self.n_heads else max(
                1, n_heads // 2)
        head_dim = 32 if n_heads else 0
        d_model = (n_heads * head_dim) if n_heads else 128
        sections = ()
        if self.m_rope_sections:
            h = head_dim // 2
            sections = (h - 2 * (h // 3), h // 3, h // 3)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_dt_rank=8 if self.is_ssm else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            m_rope_sections=sections,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            frontend_embeds=min(self.frontend_embeds, 8),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned workload shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """long_500k needs a sub-quadratic decode path (SSM state or SWA cache).

    Pure full-attention archs are skipped per spec (noted in DESIGN.md).
    """
    if shape.name != "long_500k":
        return True, ""
    if cfg.is_ssm or cfg.sliding_window:
        return True, ""
    return False, (f"{cfg.name} is pure full-attention: a 500k-deep dense KV "
                   "cache has no sub-quadratic path in this arch (skip per "
                   "spec; see DESIGN.md §4)")
