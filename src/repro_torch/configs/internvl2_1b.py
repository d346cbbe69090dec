"""internvl2-1b — InternViT + InternLM2; vision frontend is a STUB supplying
precomputed patch embeddings (DESIGN.md §4). [arXiv:2404.16821; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="vision",
    num_prefix_embeddings=1024,   # ViT patch tokens prepended to text
    source="arXiv:2404.16821; hf",
)
