"""xlstm-125m — [ssm] 12L d_model=768 4H vocab=50304, sLSTM + mLSTM blocks.
d_ff=0 per assignment: the mLSTM up-projection (x2) and sLSTM gated FFN
(pf=4/3) carry the FFN budget, per the xLSTM paper. sLSTM at blocks {1, 7}
(paper's 7:1-ish mix at small scale). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig, SSM

CONFIG = ArchConfig(
    name="xlstm-125m",
    family=SSM,
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_at=(1, 7),
    ssm_chunk=128,
)
