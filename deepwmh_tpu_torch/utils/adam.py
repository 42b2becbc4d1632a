"""``optax.adam`` written out for the registration optimisers.

For each parameter p with gradient g, at step t = 1, 2, ...:

    m <- (1 - b1) * g + b1 * m
    v <- (1 - b2) * g^2 + b2 * v
    u  = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)     (eps outside the sqrt)
    p <- p + (-lr) * u

each product rounded on its own, as optax forms them; the bias corrections
are computed in f32 on the host. An update is a handful of ``_foreach``
launches over all parameters and never waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch


class Adam:
    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        """Update ``self.params`` in place from ``grads`` (one per param)."""
        grads = list(grads)
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_add_(self.v, sq)
        m_hat = torch._foreach_div(self.m, bc1)
        denom = torch._foreach_div(self.v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_mul_(m_hat, -self.lr)
        torch._foreach_add_(self.params, m_hat)
