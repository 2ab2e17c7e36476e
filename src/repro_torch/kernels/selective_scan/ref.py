"""Plain PyTorch version of the selective scan (port of
``repro/kernels/selective_scan/ref.py``): the sequential recurrence as a
Python loop over time, with the reference's expressions in the reference's
order."""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(dt: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence: ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
    ``y_t = C_t . h_t``. All float32.

    dt/x ``(B,S,Di)``, A ``(Di,N)``, b/c ``(B,S,N)``, h0 ``(B,Di,N)``.
    Returns y ``(B,S,Di)`` and the final state ``(B,Di,N)``.
    """
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dt_t, b_t, c_t, x_t = dt[:, t], b[:, t], c[:, t], x[:, t]
        abar = torch.exp(dt_t[..., None] * A)             # (B,Di,N)
        bx = (dt_t * x_t)[..., None] * b_t[:, None, :]
        h = abar * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x)
    return y, h
