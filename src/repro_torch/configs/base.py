"""Model and shape configuration for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig` holding the
*logical* (published) dimensions.  Sharding-time padding (TP divisibility for
heads / vocab) is derived via :meth:`ModelConfig.padded` and never mutates the
logical config — see DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class PaddedDims:
    """TP-divisible dimensions derived from a logical config for a given tp."""

    num_q_heads: int
    num_kv_heads: int
    q_group: int          # q heads per kv head after padding
    vocab_size: int
    head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding window size; 0 = full attention
    global_layers: Tuple[int, ...] = ()  # layer indices forced to full attention

    # ssm / hybrid
    ssm_state: int = 0
    conv_width: int = 4

    # modality frontend stubs (DESIGN.md §4): embeddings are inputs
    frontend: Optional[str] = None   # 'vision' | 'audio'
    num_prefix_embeddings: int = 0   # e.g. vision patch tokens

    # encoder-decoder
    is_encoder_decoder: bool = False
    decoder_ratio: int = 8           # decoder_len = seq_len // decoder_ratio

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                 # provenance tag from the assignment

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_full_attention(self) -> bool:
        """True when *every* token attends to the whole prefix (no recurrent or
        windowed bound) — such archs skip long_500k per the assignment."""
        return self.family in ("dense", "moe", "vlm", "encdec")

    @property
    def has_decode_step(self) -> bool:
        return True  # all assigned archs have a decoder (enc-dec included)

    def padded(self, tp: int) -> PaddedDims:
        """TP-divisible head/vocab padding (DESIGN.md §4).

        - q heads are padded up to a multiple of tp,
        - kv heads are padded/replicated up to ``min`` multiple of tp that also
          divides the padded q count evenly (so per-device GQA grouping works),
        - vocab is padded to a multiple of max(256, tp).
        """
        hd = self.resolved_head_dim
        nq = _round_up(self.num_heads, tp)
        nkv = self.num_kv_heads
        if nkv % tp != 0 and tp % nkv != 0:
            nkv = tp
        nkv = max(nkv, tp) if nkv < tp else nkv
        # ensure padded q divides evenly into kv groups
        nq = _round_up(nq, nkv) if nq % nkv else nq
        vocab = _round_up(self.vocab_size, max(256, tp))
        return PaddedDims(
            num_q_heads=nq,
            num_kv_heads=nkv,
            q_group=nq // nkv,
            vocab_size=vocab,
            head_dim=hd,
        )

    def padded_config(self, tp: int) -> "ModelConfig":
        """This config with heads and vocab as ``padded(tp)`` gives them:
        the one-device model equal to the one built on a mesh with
        ``model = tp``, which takes the same params."""
        pd = self.padded(tp)
        return dataclasses.replace(self, num_heads=pd.num_q_heads,
                                   num_kv_heads=pd.num_kv_heads,
                                   vocab_size=pd.vocab_size,
                                   head_dim=pd.head_dim)

    # ----- analytic parameter counts (logical dims) -----
    def param_count(self, padded_tp: int = 1) -> int:
        """Total parameter count. With padded_tp>1, counts the padded tensors
        actually allocated when sharded tp-ways."""
        p = self.padded(padded_tp)
        hd = p.head_dim
        nq, nkv, v = p.num_q_heads, p.num_kv_heads, p.vocab_size
        if padded_tp == 1:
            nq, nkv, v = self.num_heads, self.num_kv_heads, self.vocab_size
        d = self.d_model
        embed = v * d
        lm_head = 0 if self.tie_embeddings else v * d

        def attn_params() -> int:
            n = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            if self.qkv_bias:
                n += (nq + 2 * nkv) * hd
            return n

        def dense_ffn() -> int:
            return 3 * d * self.d_ff  # gated GLU: up, gate, down

        def moe_ffn() -> int:
            return self.num_experts * 3 * d * self.d_ff + d * self.num_experts

        def ssm_params() -> int:
            # mamba2-style: in_proj (x,z,B,C,dt) + conv + out_proj
            d_inner = 2 * d
            return (d * (2 * d_inner + 2 * self.ssm_state * max(1, self.num_heads)
                         + max(1, self.num_heads))
                    + d_inner * self.conv_width + d_inner * d)

        per_layer = 2 * d  # norms
        if self.family in ("dense", "vlm"):
            per_layer += attn_params() + dense_ffn()
        elif self.family == "moe":
            per_layer += attn_params() + moe_ffn()
        elif self.family == "ssm":
            # xlstm pair block: mLSTM (qkv-style matrix memory, proj 2x) + sLSTM
            d_in = 2 * d
            mlstm = d * d_in * 2 + d_in * d + 3 * d_in * hd + 4 * d_in
            slstm = 4 * d * d + 4 * d + d * d
            per_layer += (mlstm + slstm) // 2  # averaged per layer (pair-scan)
        elif self.family == "hybrid":
            per_layer += attn_params() + dense_ffn() + ssm_params()
        elif self.family == "encdec":
            # enc layer: attn + ffn; dec layer: self + cross + ffn → average
            per_layer += attn_params() + dense_ffn() + (attn_params() + 2 * d) // 2
        return embed + lm_head + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (== param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        moe_active = self.num_experts_per_tok * 3 * d * self.d_ff
        moe_total = self.num_experts * 3 * d * self.d_ff
        return self.param_count() - self.num_layers * (moe_total - moe_active)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """long_500k only runs for sub-quadratic archs (DESIGN.md §4)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and cfg.is_full_attention:
            continue
        out.append(s)
    return tuple(out)


def suggest_microbatches(cfg: ModelConfig, shape: ShapeSpec, num_data_shards: int,
                         act_budget_bytes: float = 2e9) -> int:
    """Pick a gradient-accumulation factor so saved activations (block inputs
    under full remat) stay under the budget per device."""
    if shape.kind != "train":
        return 1
    local_batch = max(1, shape.global_batch // num_data_shards)
    per_sample = cfg.num_layers * shape.seq_len * cfg.d_model * 2  # bf16 block inputs
    max_mb_size = max(1, int(act_budget_bytes // max(1, per_sample)))
    mb_size = min(local_batch, max_mb_size)
    num_mb = max(1, local_batch // max(1, mb_size))
    while local_batch % num_mb:
        num_mb += 1
    return num_mb
