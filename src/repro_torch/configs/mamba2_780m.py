"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]  Copied from ``repro/configs/mamba2_780m.py``."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

ARCH = register(ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64),
    norm="rmsnorm",
    tie_embeddings=True,
))
