"""Architecture configs: the port's own copy of the JAX package's
``configs/base.py`` (pure Python, no framework).

Every architecture has a module ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the full-scale config) and ``smoke()`` (a reduced variant of
the same family used by the CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation for the config numbers

    # transformer trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    qk_norm: bool = False
    tie_embeddings: bool = False
    gated_mlp: bool = True           # SwiGLU; False -> 2-matrix GELU (granite)

    # MoE
    n_experts: int = 0               # 0 => dense FFN
    moe_top_k: int = 0
    moe_every: int = 1               # MoE FFN every k-th layer (1 = all layers)
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0               # N; 0 => no SSM layers
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (jamba): attention layer every `attn_every` layers; others SSM
    attn_every: int = 0              # 0 => not hybrid

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500              # audio frame positions (stubbed frontend)

    # VLM
    n_patches: int = 0               # image patch embeddings prepended (stubbed frontend)

    # attention variant for long-context decode
    sliding_window: int = 8192

    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0 and not self.is_encoder_decoder

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D roofline term)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        hd = self.head_dim

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def dense_ffn() -> int:
            return (3 if self.gated_mlp else 2) * d * f

        def moe_ffn() -> int:
            return self.n_experts * 3 * d * f + d * self.n_experts  # experts + router

        def ssm_params() -> int:
            di, n = self.d_inner, self.ssm_state
            in_proj = d * (2 * di + 2 * n + self.ssm_heads)  # x, z, B, C, dt
            conv = self.ssm_conv_width * (di + 2 * n)
            out = di * d
            return in_proj + conv + out + 2 * self.ssm_heads  # + A, D per head

        if self.is_encoder_decoder:
            for _ in range(self.n_enc_layers):
                total += attn_params() + dense_ffn() + 2 * d
            for _ in range(self.n_layers):
                total += 2 * attn_params() + dense_ffn() + 3 * d  # self + cross
            return total

        for i in range(self.n_layers):
            if self.is_hybrid:
                is_attn = (i % self.attn_every) == (self.attn_every - 1)
                total += attn_params() if is_attn else ssm_params()
            elif self.is_ssm_only:
                total += ssm_params()
            else:
                total += attn_params()
            if self.ssm_state == 0 or self.is_hybrid:
                use_moe = self.is_moe and (i % self.moe_every == self.moe_every - 1)
                total += moe_ffn() if use_moe else dense_ffn()
            total += 2 * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if (self.ssm_state == 0 or self.is_hybrid)
            and (i % self.moe_every == self.moe_every - 1)
        )
        inactive = n_moe_layers * (self.n_experts - self.moe_top_k) * 3 * self.d_model * self.d_ff
        return full - inactive


# ----------------------------------------------------------------------
ARCH_IDS: Tuple[str, ...] = (
    "phi3_5_moe_42b",
    "jamba_v0_1_52b",
    "smollm_135m",
    "internvl2_2b",
    "whisper_tiny",
    "mamba2_370m",
    "llama4_scout_17b",
    "moonshot_v1_16b",
    "granite_34b",
    "qwen3_1_7b",
    "fmnist_cnn",          # the paper's own model (FL workhorse, not a transformer)
)

# CLI-friendly aliases matching the assignment sheet.
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "smollm-135m": "smollm_135m",
    "internvl2-2b": "internvl2_2b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-370m": "mamba2_370m",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "granite-34b": "granite_34b",
    "qwen3-1.7b": "qwen3_1_7b",
    "fmnist-cnn": "fmnist_cnn",
}

# every architecture has its config module in the port
PORTED = ARCH_IDS


def _config_module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _config_module(arch).smoke()


# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
