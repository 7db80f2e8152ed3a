from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.schedules import constant, cosine_with_warmup

__all__ = ["AdamW", "AdamWState", "global_norm", "constant",
           "cosine_with_warmup"]
