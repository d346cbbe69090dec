"""seamless-m4t-medium — encoder-decoder; audio frontend is a STUB supplying
precomputed frame embeddings (DESIGN.md §4). [arXiv:2308.11596; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,               # per stack: 12 encoder + 12 decoder
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    frontend="audio",
    decoder_ratio=8,             # decoder_len = seq_len // 8 (DESIGN.md §4)
    source="arXiv:2308.11596; hf",
)
