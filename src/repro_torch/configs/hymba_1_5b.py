"""hymba-1.5b — hybrid: parallel attention + mamba heads per block; 3 global
attention layers, the rest sliding-window. [arXiv:2411.13676; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    window=2048,
    global_layers=(0, 15, 31),
    source="arXiv:2411.13676; hf",
)
