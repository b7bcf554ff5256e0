"""Model configuration schema + registry for `--arch <id>` selection."""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelConfig", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    mlp: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 10000.0
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0         # per-head state width (Mamba2 d_state / RWKV key)
    ssm_heads: int = 0
    ssm_conv: int = 4          # depthwise causal conv width (Mamba2)
    hybrid_attn_every: int = 0  # zamba2: shared attn block period (layers/group)
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500     # stubbed conv-frontend output length
    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0  # cross-attn layer period within the decoder
    vision_tokens: int = 1601  # stubbed patch-embedding count per image
    vision_dim: int = 1280     # stubbed frontend embedding width
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False  # supports long_500k shapes

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            moe_experts=min(self.moe_experts, 4),
            moe_topk=min(self.moe_topk, 2),
            capacity_factor=8.0,  # effectively dropless at smoke-test sizes
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=32 if self.enc_layers else 0,
            hybrid_attn_every=3 if self.hybrid_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            vision_tokens=16 if self.cross_attn_every else 0,
            vision_dim=32 if self.cross_attn_every else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-flops in the roofline)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, hq, hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        mlp = (3 if self.mlp == "swiglu" else 2) * d * ff
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + mlp
        elif self.family == "moe":
            router = d * self.moe_experts
            per_layer = attn + self.moe_experts * mlp + router
            if self.moe_dense_residual:
                per_layer += mlp
        elif self.family == "ssm":
            k = self.ssm_state
            h = self.ssm_heads
            per_layer = 5 * d * (h * k) + d * ff * 2  # r,k,v,w,g + channel mix
        elif self.family == "hybrid":
            k = self.ssm_state
            nh = self.ssm_heads or self.n_heads
            inner = 2 * d
            per_layer = d * 2 * inner + inner * 2 * nh * k + inner * d + mlp // 4
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = self.n_layers * per_layer + emb
        if self.family == "encdec":
            total += self.enc_layers * (attn + mlp) + self.n_layers * attn  # cross
        if self.family == "vlm" and self.cross_attn_every:
            total += (self.n_layers // self.cross_attn_every) * attn
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + mlp  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp = (3 if self.mlp == "swiglu" else 2) * d * ff
        inactive = self.n_layers * (self.moe_experts - self.moe_topk) * mlp
        return int(self.param_count() - inactive)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # late import to populate registry

    _load_all()
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
