"""The control: the reference computed in float8 (e4m3, one scale per
tensor from its largest magnitude), the step below the bfloat16 that the
configurations state.  Every product takes its operands rounded to
float8, accumulates in float32 and rounds its result to float8, and every
activation that the program stores in bfloat16 is stored in float8
(``model.Precision``); the head's product, which the program computes in
float32, takes float8 operands and keeps its float32 result.  The gradient
passes each rounding unchanged (straight through)."""
from __future__ import annotations

import torch

from portbench.reference.model import Precision

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp8_round(fp8_head(a, b))


def fp8_head(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp8_round(a) @ fp8_round(b)


FP8 = Precision(fp8_mm, fp8_head, fp8_round)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t.detach())


def bf16_head(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bf16_round(a) @ bf16_round(b)


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bf16_round(bf16_head(a, b))


# the configuration's own precision at the same points, for the look at
# what a sound program's readings come from (``readings.py``)
BF16 = Precision(bf16_mm, bf16_head, bf16_round)
