"""zamba2-2.7b — [hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Mamba2 backbone + shared attention block applied
every 6 layers (9 applications, shared weights). [arXiv:2411.15242; hf]

long_500k note: the shared attention runs with a 4096 sliding window in the
long-context cell (see launch/dryrun.py), keeping decode sub-quadratic; the
Mamba2 layers carry the long-range state.
"""
from repro_torch.configs.base import ArchConfig, HYBRID

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
)
