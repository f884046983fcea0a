"""Model configuration (a copy of ``repro.models.config``, which the port
does not import).

One frozen dataclass covers all five assigned families (dense / moe / ssm /
hybrid / encoder / vlm-backbone).  Layers are organized as repeating
*superblocks* (the layer pattern); parameters of one pattern position are
stacked along a leading superblock axis and the forward pass loops over it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


# block kinds usable inside a superblock pattern
ATTN_KINDS = {"attn", "attn_bidir", "attn_sliding", "attn_chunked",
              "attn_global", "attn_local"}
MIXER_KINDS = ATTN_KINDS | {"ssd", "rglru"}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer pattern: one superblock = this tuple of mixer kinds; the stack is
    # pattern * n_superblocks + pattern[:remainder]
    block_pattern: tuple = ("attn",)

    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    causal: bool = True
    window: int = 0                  # sliding/local attention window
    chunk_size: int = 0              # llama4-style chunked attention
    rope_theta: float = 10000.0
    pos_type: str = "rope"           # rope | mrope | none
    mrope_sections: tuple = ()       # e.g. (16, 24, 24) for qwen2-vl
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dff: int = 0                 # per-expert hidden dim (0 -> d_ff)
    shared_expert_dff: int = 0       # always-on shared expert hidden dim
    first_k_dense: int = 0           # leading dense layers (DeepSeek-style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- RG-LRU (Griffin / RecurrentGemma) ---
    lru_width: int = 0               # 0 -> d_model

    # --- modality stub frontends ---
    modality: str = "text"           # text | vision_stub | audio_stub
    frontend_tokens: int = 0         # patches/frames injected per sample

    # ------------------------------------------------------------------

    def __post_init__(self):
        assert self.num_layers >= 1
        for k in self.block_pattern:
            assert k in MIXER_KINDS, k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def n_superblocks(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> tuple:
        r = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:r]

    @property
    def d_inner(self) -> int:       # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    # ------------------------------------------------------------------
    # analytic parameter / FLOP accounting (used by the roofline)
    # ------------------------------------------------------------------

    def mixer_params(self, kind: str) -> int:
        D, dh = self.d_model, self.resolved_head_dim
        H, K = self.num_heads, self.num_kv_heads
        if kind in ATTN_KINDS:
            qkv = D * (H * dh) + 2 * D * (K * dh)
            if self.qkv_bias:
                qkv += (H + 2 * K) * dh
            out = (H * dh) * D
            return qkv + out
        if kind == "ssd":
            di, N, G = self.d_inner, self.ssm_state, self.ssm_groups
            nh = self.ssm_heads
            in_proj = D * (2 * di + 2 * G * N + nh)
            conv = (di + 2 * G * N) * self.ssm_conv
            extra = 3 * nh          # A_log, D, dt_bias
            out = di * D + di       # out_proj + gated norm
            return in_proj + conv + extra + out
        if kind == "rglru":
            W = self.resolved_lru_width
            return 2 * D * W + W * self.ssm_conv + 3 * W + W * D
        raise ValueError(kind)

    def ffn_params(self, layer_idx: int) -> int:
        D = self.d_model
        if self.num_experts and layer_idx >= self.first_k_dense:
            dff = self.moe_dff or self.d_ff
            p = self.num_experts * 3 * D * dff + D * self.num_experts
            if self.shared_expert_dff:
                p += 3 * D * self.shared_expert_dff
            return p
        gate_mult = 3  # gated MLPs everywhere (SwiGLU/GeGLU)
        return gate_mult * D * self.d_ff

    def ffn_active_params(self, layer_idx: int) -> int:
        D = self.d_model
        if self.num_experts and layer_idx >= self.first_k_dense:
            dff = self.moe_dff or self.d_ff
            p = self.experts_per_token * 3 * D * dff + D * self.num_experts
            if self.shared_expert_dff:
                p += 3 * D * self.shared_expert_dff
            return p
        return 3 * D * self.d_ff

    def _layer_kinds(self):
        kinds = list(self.block_pattern) * self.n_superblocks
        kinds += list(self.remainder_pattern)
        return kinds

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model     # lm head
        for i, kind in enumerate(self._layer_kinds()):
            n += self.mixer_params(kind) + self.ffn_params(i)
            n += 2 * self.d_model                   # the two norms
        n += self.d_model                           # final norm
        return n

    def active_param_count(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for i, kind in enumerate(self._layer_kinds()):
            n += self.mixer_params(kind) + self.ffn_active_params(i)
            n += 2 * self.d_model
        n += self.d_model
        return n

    def flops_parts(self, tokens: int, *, training: bool = True,
                    seq_len: int = 1, kv_len: int = 0) -> dict:
        """MODEL_FLOPS split into the 6·N·D projection term and the
        attention quadratic term (which 6ND famously omits).

        The embedding *gather* does no matmul work, so one V·D table is
        excluded from the FLOP-bearing parameter count (the unembed matmul
        keeps its V·D whether tied or not)."""
        mult = 6.0 if training else 2.0
        flop_params = self.active_param_count() - self.vocab_size * self.d_model
        base = mult * flop_params * tokens
        # attention score/PV FLOPs: fwd = 4·eff·H·dh per token (two matmuls);
        # training adds bwd (8) = 12 (remat recompute excluded: reported via
        # the useful-flops ratio instead)
        dh, H = self.resolved_head_dim, self.num_heads
        attn_unit = 12.0 if training else 4.0
        attn = 0.0
        for kind in self._layer_kinds():
            if kind not in ATTN_KINDS:
                continue
            if kv_len:      # decode: each token sees kv_len history
                eff = min(kv_len, self._attn_span(kind, kv_len))
                attn += attn_unit * tokens * eff * H * dh
            else:           # self-attention over seq_len, causal ≈ /2
                eff = min(seq_len, self._attn_span(kind, seq_len))
                frac = 0.5 if self.causal else 1.0
                attn += attn_unit * tokens * eff * frac * H * dh
        return {"base": base, "attn": attn}

    def model_flops(self, tokens: int, *, training: bool = True,
                    seq_len: int = 1, kv_len: int = 0) -> float:
        parts = self.flops_parts(tokens, training=training, seq_len=seq_len,
                                 kv_len=kv_len)
        return parts["base"] + parts["attn"]

    def _attn_span(self, kind: str, default: int) -> int:
        if kind in ("attn_sliding", "attn_local"):
            return self.window or default
        if kind == "attn_chunked":
            return self.chunk_size or default
        return default

    def supports_decode(self) -> bool:
        return self.causal

    def subquadratic(self) -> bool:
        """True if no layer attends to unbounded history (long_500k-able)."""
        return all(k not in ("attn", "attn_global", "attn_bidir")
                   for k in self._layer_kinds())

    def long_context_ok(self) -> bool:
        """long_500k policy: SSM/hybrid/windowed archs qualify; archs with a
        *few* global layers qualify via sequence-sharded decode attention."""
        kinds = self._layer_kinds()
        n_global = sum(k in ("attn", "attn_global") for k in kinds)
        return self.causal and (n_global == 0 or
                                (n_global <= len(kinds) // 4 and
                                 self.family in ("moe", "hybrid")))
