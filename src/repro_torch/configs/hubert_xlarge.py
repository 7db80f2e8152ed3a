"""hubert-xlarge [audio] — encoder-only, wav2vec2 architecture.
[arXiv:2106.07447]

The conv feature extractor (waveform -> 50 Hz frames) is a stub, as in the
reference: the batch carries precomputed frame embeddings (batch, seq,
d_model).  The training objective is masked-unit prediction over the
504 cluster codes.  Encoder-only: no decode shapes.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="hubert-xlarge",
    arch_type="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab=504,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=80, causal=False),
    encoder_only=True,
    modality="audio_stub",
    mlp_act="gelu",
    norm="layernorm",
))
