"""Whisper-base [arXiv:2212.04356] — encoder-decoder, audio.

6L (enc) + 6L (dec), d_model=512, 8H (full MHA), d_ff=2048, vocab=51865.
The mel-spectrogram + conv1/conv2 frontend is STUBBED: ``input_specs``
provides (B, 1500, 512) frame embeddings.  Decoder positions are
sinusoidal here (the release uses a learned 448-slot table; our assigned
decode shapes exceed it — deviation recorded in DESIGN.md).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="whisper-base",
    arch_type="encdec",
    num_layers=6,  # decoder layers
    encoder_layers=6,
    encoder_frames=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    tie_embeddings=True,
    use_rope=False,  # absolute (sinusoidal) positions
    attn_seq_shard=True,  # 8 heads % 16 != 0 (§Perf #2)
)
