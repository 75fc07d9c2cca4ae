"""Per-step condition processor and the global attention gate (counterpart of
``cwfa_tpu/models/cond_net.py``).

``CondNetwork`` maps the lenslet views (B, n_lenslets, H, W) to the
conditioning features (B, n_depths/2^{k+1}, H, W) of CWF step k
(reference networks.py:165-242):

  out = PReLU( conv3x3(PReLU(conv3x3(x))) + conv3x3_downsample(x) )
  out = Conv3d(K->1) o PReLU o Conv3d(1->K)  over (H, W, depth)

One PReLU alpha per net is shared by its three activation sites.  The 3-D
pair runs in one call of ``ops/cond_pair.cond_pair`` on the (B, D, H, W)
features (the CUDA kernel on a card, its plain version on the CPU), with the
reference layout's weights (``_conv3d_pair_direct``, ``cond_net.py:259-265``):
the TPU's banded, depth-batched and block-diagonally paired forms are
numerically equal rewrites and are not carried over.  Inference only: the
Dropout3d of training is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cwfa_tpu_torch.nn import same_conv2d
from cwfa_tpu_torch.ops.cond_pair import cond_pair


class CondNetwork(nn.Module):
    def __init__(self, c_in: int, c_out: int, chans_3d: int = 32):
        super().__init__()
        self.conv1 = same_conv2d(c_in, c_out, 3)
        self.conv2 = same_conv2d(c_out, c_out, 3)
        self.down = same_conv2d(c_in, c_out, 3)
        self.c3a = nn.Conv3d(1, chans_3d, 3, padding=1)
        self.c3b = nn.Conv3d(chans_3d, 1, 3, padding=1)
        self.prelu = nn.PReLU(1)

    def forward(self, x):
        """x: (B, n_lenslets, H, W) -> contiguous (B, c_out, H, W)."""
        if self.training:
            raise NotImplementedError("cond net training is not ported")
        out = self.prelu(self.conv1(x))
        out = self.conv2(out)
        out = self.prelu(out + self.down(x))
        # the 3-D convs run over (H, W, depth)
        return cond_pair(out.contiguous(), self.c3a, self.c3b, self.prelu)


def cond_networks_batched(nets, x):
    """All per-step condition nets on the same views (inference path)."""
    return [net(x) for net in nets]


class GlobalAttention(nn.Module):
    """Conv1d(C,C,3) -> ReLU -> Conv1d(C,C,1) -> Sigmoid gate over the
    flattened spatial dim (reference networks.py:244-262)."""

    def __init__(self, n_chans: int):
        super().__init__()
        self.c1 = nn.Conv1d(n_chans, n_chans, 3, padding=1)
        self.c2 = nn.Conv1d(n_chans, n_chans, 1)

    def forward(self, x):
        b, c = x.shape[:2]
        y = F.relu(self.c1(x.reshape(b, c, -1)))
        return torch.sigmoid(self.c2(y)).reshape(x.shape)
