"""Model / input-shape configuration schema.

Every assigned architecture (see ``src/repro/configs/<id>.py``) instantiates
``ModelConfig`` with its published values; ``reduced()`` derives the CPU
smoke-test variant (2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    mlp: str = "swiglu"          # swiglu | geglu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE channel mixer at layers where
                                 # (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_width: int = 4
    # --- hybrid interleave: attention at layers where i % attn_every == 0;
    #     0 means attention-free (pure SSM); 1 means attention everywhere.
    attn_every: int = 1
    # --- modality frontends (stubbed per the carve-out): cross-attention
    #     layers every N consume precomputed patch/frame embeddings.
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0   # patches / conditioning frames
    # --- attention details ---
    rope_theta: float = 10_000.0
    attn_window: int = 0         # 0 = full causal; >0 = sliding window
    norm_eps: float = 1e-6
    dtype: object = torch.bfloat16
    source: str = ""             # citation
    # scan (compile-time-friendly) vs unrolled (accurate per-layer cost
    # analysis — XLA's cost model counts a while-loop body once) layers.
    scan_layers: bool = True
    # remat policy: "full" recomputes everything in backward (including TP
    # collectives); "dots" saves matmul outputs so collectives feeding
    # them are not re-run (§Perf hillclimb B).
    remat_policy: str = "full"
    # expert-parallel MoE with explicit shard_map all-to-all (§Perf B2)
    # instead of the pjit scatter-dispatch formulation.
    moe_ep: bool = False
    # attention implementation: "xla" (einsum, lowers for the dry-run) or
    # "pallas" (flash kernel in interpret mode — kernels as a first-class
    # model option, CPU-validated; compiles natively on real TPU).
    attn_impl: str = "xla"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.attn_every != 0

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    # Scan periodicity: the layer stack is a scan over identical
    # super-blocks of ``period`` layers (MaxText-style stacked params).
    @property
    def period(self) -> int:
        p = 1
        if self.family == "hybrid":
            p = self.attn_every
            if self.uses_moe:
                # lcm with moe_every
                import math
                p = p * self.moe_every // math.gcd(p, self.moe_every)
        elif self.cross_attn_every:
            p = self.cross_attn_every
        elif self.uses_moe and self.moe_every > 1:
            p = self.moe_every
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    # Layer descriptors within one period: (mixer, channel) pairs.
    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        plan = []
        for p in range(self.period):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.family == "hybrid":
                mixer = "attn" if p % self.attn_every == 0 else "ssm"
            elif self.cross_attn_every and p % self.cross_attn_every == (
                self.cross_attn_every - 1
            ):
                mixer = "cross_attn"
            else:
                mixer = "attn"
            if self.family == "ssm":
                channel = "none" if self.d_ff == 0 else "mlp"
            elif self.uses_moe and p % self.moe_every == self.moe_offset:
                channel = "moe"
            else:
                channel = "mlp"
            plan.append((mixer, channel))
        return tuple(plan)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family: <=2 super-blocks,
        d_model<=512, <=4 experts."""
        period = self.period
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        # keep the GQA ratio flavor: at least 1 kv head
        n_kv = max(1, min(n_kv, n_heads))
        return dataclasses.replace(
            self,
            n_layers=period * min(2, self.n_periods),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=min(self.hd, 64),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=min(self.ssm_chunk, 32),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            attn_window=min(self.attn_window, 64) if self.attn_window else 0,
            dtype=torch.float32,
            name=self.name + "-smoke",
        )

    def param_count(self) -> int:
        """Approximate parameter count (for payload-size computations)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        for mixer, channel in self.layer_plan() * self.n_periods:
            if mixer in ("attn", "cross_attn"):
                total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * self.hd * d
                if mixer == "cross_attn":
                    total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
            elif mixer == "ssm":
                di, g, s, h = (
                    self.ssm_d_inner, self.ssm_groups, self.ssm_state,
                    self.ssm_heads,
                )
                total += d * (2 * di + 2 * g * s + h) + di * d
            if channel == "mlp":
                total += 3 * d * self.d_ff
            elif channel == "moe":
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * self.d_ff
        total += d  # final norm
        return total


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str         # train | prefill | decode
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

# Sliding window applied to full-attention families for long_500k
# (see DESIGN.md §5 — the sub-quadratic carve-in for dense archs).
LONG_CONTEXT_WINDOW = 8_192
