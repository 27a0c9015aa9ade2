"""gemma2-2b — [dense] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096-window)/global alternating attention, attn/final logit softcaps,
head_dim=256, embedding scaled by sqrt(d). [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="gemma2-2b",
    family=DENSE,
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu_tanh",
)
