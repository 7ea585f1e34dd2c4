"""F-05 feature propagation: inverse-distance 3-NN interpolation.

The 3-NN query itself is `kernels.knn.flash_three_nn` (the decoder's
`method="pallas"`); `dense_three_nn` and `grid_three_nn` are not ported yet.
"""

from __future__ import annotations

import torch


def three_nn_interpolate(support_feat: torch.Tensor, nn_idx: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Inverse-distance feature interpolation: [B,Ns,C] → [B,Nq,C].

    nn_idx [B, Nq, k], weights [B, Nq, k]. The sum runs neighbor by
    neighbor, w0·f0 + w1·f1 + w2·f2 left to right, the JAX package's add
    order."""
    b = torch.arange(support_feat.shape[0],
                     device=support_feat.device)[:, None]
    out = weights[..., 0:1] * support_feat[b, nn_idx[..., 0]]
    for j in range(1, nn_idx.shape[-1]):
        out = out + weights[..., j:j + 1] * support_feat[b, nn_idx[..., j]]
    return out
