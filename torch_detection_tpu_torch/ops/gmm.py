"""Fixed-iteration EM of a two-component 1-D Gaussian mixture over masked
slates, batched over any leading dims.

Counterpart of ``torch_detection_tpu/ops/gmm.py``: PAA splits each gt's
candidate losses into a low-loss and a high-loss component with it. The
initialisation is PAA's (means at the slate's min and max, unit
variances, weights 0.5); padded entries are set to 0 before any density
is computed (a 3e38 sentinel would overflow ``d * d`` to inf and poison
the fit with NaN), every variance carries the ``reg_covar`` floor, and
``nk`` and the weights are floored at 1e-12 so that an empty component
keeps a finite log. The reference's ``fori_loop`` is a Python loop of
``n_iter`` steps over the whole (..., C) batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

_LOG_2PI = 1.8378770664093453


class GMMResult(NamedTuple):
    resp: Tensor  # (..., C, 2) responsibilities, 0 on invalid rows
    log_prob: Tensor  # (..., C) each sample's mixture log-likelihood
    means: Tensor  # (..., 2)
    variances: Tensor  # (..., 2)
    weights: Tensor  # (..., 2)


def gmm_em_1d(
    x: Tensor,  # (..., C) sample values
    valid: Tensor,  # (..., C) bool
    n_iter: int = 25,
    reg_covar: float = 1e-6,
) -> GMMResult:
    """Fit a 2-component 1-D Gaussian mixture to the valid entries of each
    (..., C) slate. With 0 or 1 valid samples the parameters stay near
    their initialisation; callers mask on ``valid``."""
    x = torch.where(valid, x.float(), 0.0)
    v = valid.float()
    n = v.sum(-1).clamp(min=1.0)[..., None]  # (..., 1)
    big = 1e30
    any_valid = valid.any(-1)
    mean0 = torch.where(valid, x, big).amin(-1)
    mean1 = torch.where(valid, x, -big).amax(-1)
    means = torch.where(any_valid[..., None], torch.stack([mean0, mean1], -1), 0.0)
    variances = torch.ones_like(means)
    weights = torch.full_like(means, 0.5)
    xs = x[..., None]  # (..., C, 1)

    def e_step(means, variances, weights):
        d = xs - means[..., None, :]
        wlp = (torch.log(weights)[..., None, :]
               - 0.5 * (_LOG_2PI + torch.log(variances))[..., None, :]
               - 0.5 * d * d / variances[..., None, :])  # (..., C, 2)
        log_norm = torch.logsumexp(wlp, dim=-1, keepdim=True)
        return torch.exp(wlp - log_norm) * v[..., None], log_norm[..., 0]

    def m_step(resp):
        nk = resp.sum(-2)  # (..., 2)
        nk_safe = nk.clamp(min=1e-12)
        means = (resp * xs).sum(-2) / nk_safe
        d = xs - means[..., None, :]
        variances = (resp * d * d).sum(-2) / nk_safe + reg_covar
        return means, variances, (nk / n).clamp(min=1e-12)

    for _ in range(n_iter):
        means, variances, weights = m_step(e_step(means, variances, weights)[0])
    resp, log_prob = e_step(means, variances, weights)
    return GMMResult(resp, log_prob, means, variances, weights)
