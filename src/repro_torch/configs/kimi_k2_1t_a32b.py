"""kimi-k2-1t-a32b — trillion-param fine-grained MoE (384 experts, top-8).
[arXiv:2501.kimi2; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    num_experts_per_tok=8,
    source="arXiv:2501.kimi2; unverified",
)
