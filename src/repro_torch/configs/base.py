"""Model/config schema for the assigned architectures (PyTorch port).

A copy of `repro.configs.base` without its ANNS dataset table, which the
port keeps in `repro_torch/data/synthetic.py`."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    """One LM-family architecture (exact dims from the assignment table).

    family: dense | moe | vlm | ssm | hybrid | audio
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    capacity_factor: float = 1.25
    # >0: dispatch tokens to experts in this many independent chunks, each
    # local to one data shard (set = data-axis size). Removes ALL cross-
    # device traffic from the scatter/combine; capacity is enforced per
    # chunk. 0 = paper-baseline global dispatch. §Perf hillclimb #B.
    moe_dispatch_chunks: int = 0

    # SSM (Mamba2 / xLSTM)
    ssm_state_dim: int = 0
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128               # SSD chunk length
    ssm_heads: int = 0                 # 0 -> derived (d_inner // 64)

    # hybrid (zamba2): one SHARED attention block applied every attn_every
    # ssm layers
    attn_every: int = 0

    # attention details
    rope_theta: float = 10000.0
    causal: bool = True
    is_encoder: bool = False
    sliding_window: int = 0            # 0 = full attention
    attn_chunk_q: int = 512            # blockwise-attention tile sizes
    attn_chunk_kv: int = 1024

    # frontends for [audio]/[vlm]: stubs per spec — input_specs() supplies
    # precomputed frame/patch embeddings or VQ token ids
    frontend: str = "token"            # token | frames

    # use the flash-attention kernel (kernels/flash_attention) for the
    # full-sequence path: the CUDA kernel on the card, its plain version on
    # the CPU. The blockwise path is the alternative and the numerical
    # reference.
    use_flash_kernel: bool = False

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"                # none | full — activation ckpt policy
    vocab_round: int = 256             # pad vocab for clean TP sharding

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return (self.vocab_size + r - 1) // r * r

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def is_recurrent(self) -> bool:
        """True if the arch has an O(1)-state decode path (long-context OK)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if self.attn_every == 0
                           else 2 * max(1, self.attn_every)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state_dim=min(self.ssm_state_dim, 16) if self.ssm_state_dim else 0,
            ssm_heads=4 if self.family in ("ssm", "hybrid") else 0,
            ssm_chunk=16,
            attn_chunk_q=64,
            attn_chunk_kv=64,
            vocab_round=64,
            remat="none",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode | long_decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}
