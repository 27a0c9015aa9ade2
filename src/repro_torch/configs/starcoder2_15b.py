"""starcoder2-15b — [dense] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152. GQA + RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, DENSE

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family=DENSE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=100000.0,
    act="gelu_tanh",
    gated_mlp=False,
)
