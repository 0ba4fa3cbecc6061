"""Model configuration, the port's own copy of ``repro/configs/base.py``.

One frozen dataclass covers every architecture family of the reference
(dense / MoE / SSM / hybrid / VLM / audio enc-dec), field for field, with
``dtype`` kept as a string name as the reference keeps it. The port runs
only the configs registered in ``repro_torch.configs.ARCHS``; the rest of
the fields are here so that a config crosses between the packages
unchanged. ``reduced()`` derives the CPU test variant of the same family.
"""
from __future__ import annotations

import dataclasses

from repro_torch.utils import ceil_div


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention flavour
    attention: str = "gqa"           # gqa | mla | none
    qk_norm: bool = False            # qwen3
    rope_theta: float = 10000.0

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_every: int = 1               # MoE layer period (jamba: 2)
    moe_offset: int = 0              # MoE layer offset within period
    capacity_factor: float = 1.25

    # layer pattern (hybrid)
    block: str = "attn"              # attn | rwkv | hybrid (mamba+attn)
    attn_every: int = 1              # jamba: 8
    attn_offset: int = 0             # jamba: 4

    # mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # rwkv6
    rwkv_head_size: int = 64

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # modality frontend stubs (assignment: input_specs provides embeddings)
    frontend: str = "none"           # none | vision_stub | audio_stub
    n_prefix_embeds: int = 0         # vlm: image-patch positions in the seq

    # mlp / norm
    mlp_act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False

    dtype: str = "bfloat16"
    remat: bool = True
    # which attention positions can run sub-quadratic / O(1)-state decode
    subquadratic: bool = False       # ssm/hybrid: long_500k runnable

    # -- derived ------------------------------------------------------------
    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or ceil_div(self.d_model, 16)

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def qk_head_dim(self) -> int:
        if self.attention == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def layer_period(self) -> int:
        """Smallest repeating layer pattern (for scan-over-layers)."""
        import math
        p = 1
        if self.block == "hybrid":
            p = math.lcm(p, self.attn_every)
        if self.moe:
            p = math.lcm(p, self.moe_every)
        return p

    def is_attn_layer(self, i: int) -> bool:
        if self.attention == "none":
            return False
        if self.block == "hybrid":
            return i % self.attn_every == self.attn_offset
        return self.block == "attn"

    def is_moe_layer(self, i: int) -> bool:
        return self.moe and (i % self.moe_every == self.moe_offset)

    def param_count(self) -> int:
        """Analytic parameter count of the *specified* model (no padding)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embed
        if not self.tie_embeddings:
            total += v * d                 # lm head
        for i in range(self.n_layers):
            total += d                     # pre-norm scale
            if self.is_attn_layer(i):
                if self.attention == "mla":
                    qd = self.n_heads * self.qk_head_dim
                    total += d * self.q_lora_rank + self.q_lora_rank * qd
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                    total += self.q_lora_rank + self.kv_lora_rank  # norms
                else:
                    total += d * self.n_heads * self.head_dim
                    total += 2 * d * self.n_kv_heads * self.head_dim
                    total += self.n_heads * self.head_dim * d
                    if self.qk_norm:
                        total += 2 * self.head_dim
            elif self.block == "rwkv":
                total += 4 * d * d + d * d      # r,k,v,w(lora approximated),o
                total += 2 * d * self.d_ff + d  # channel mix
            elif self.block == "hybrid":        # mamba layer
                di, n, dr = self.mamba_d_inner, self.mamba_d_state, self.dt_rank
                total += d * 2 * di + di * self.mamba_d_conv
                total += di * (dr + 2 * n) + dr * di + di * n + 2 * di
                total += di * d
            total += d                          # post/ffn norm
            if self.is_moe_layer(i):
                e, h = self.n_experts, self.moe_d_ff
                total += d * e                  # router
                total += e * 3 * d * h
                total += self.n_shared_experts * 3 * d * h
            elif self.block != "rwkv":
                mult = 3 if self.mlp_act == "swiglu" else 2
                total += mult * d * self.d_ff
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += 4 * d * self.head_dim * self.n_heads + \
                    2 * d * self.d_ff + 2 * d
            # decoder cross-attention
            total += self.n_layers * (4 * d * self.head_dim * self.n_heads + d)
        total += d                              # final norm
        return int(total)

    def param_count_active(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        # subtract inactive expert weights
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                inactive = self.n_experts - self.moe_top_k
                total -= inactive * 3 * self.d_model * self.moe_d_ff
        return int(total)

    def reduced(self) -> "ModelConfig":
        """Same family, tiny dims — the CPU smoke-test variant."""
        changes = dict(
            n_layers=max(2, self.layer_period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            dtype="float32",
            remat=False,
        )
        if self.family in ("moe",) or self.moe:
            changes.update(n_experts=4, moe_top_k=2, moe_d_ff=32)
        if self.attention == "mla":
            changes.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16)
        if self.block == "rwkv":
            changes.update(rwkv_head_size=16)
        if self.block == "hybrid":
            changes.update(mamba_d_state=4, mamba_d_conv=4, mamba_dt_rank=8,
                           n_layers=self.layer_period)
        if self.enc_dec:
            changes.update(n_enc_layers=2, enc_seq=16)
        if self.frontend == "vision_stub":
            changes.update(n_prefix_embeds=4)
        # MLA keeps kv = q heads
        if self.attention == "mla":
            changes["n_kv_heads"] = changes["n_heads"]
        return dataclasses.replace(self, **changes)
