"""hubert-xlarge — [audio] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only transformer backbone (same arch as wav2vec2). The conv waveform
frontend is a STUB per the assignment: input_specs() provides precomputed
frame embeddings (B, S, 1280). Loss = frame-level CE over 504 cluster targets
(HuBERT masked-prediction style). [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ArchConfig, AUDIO

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family=AUDIO,
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    embed_inputs=False,
    d_in=1280,
    act="gelu",
)
