"""xlstm-125m — sLSTM + mLSTM blocks (pair-scanned, see DESIGN.md §4).
[arXiv:2405.04517; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,              # block-internal projections replace the FFN
    vocab_size=50304,
    source="arXiv:2405.04517; unverified",
)
