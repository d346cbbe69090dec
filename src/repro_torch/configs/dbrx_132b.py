"""dbrx-132b — fine-grained 16-expert top-4 MoE.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    source="hf:databricks/dbrx-base; unverified",
)
