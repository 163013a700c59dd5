"""Correspondence regression head (counterpart of CorrespondenceRegressor
in regtr_tpu/nn/heads.py, the `direct_regress_coor: True` path)."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class CorrespondenceRegressor(nn.Module):
    """3-layer MLP coordinate regression + overlap logit.

    feats (L, 2B, N, D) -> (corr (L, 2B, N, 3), overlap (L, 2B, N, 1)).
    """

    def __init__(self, d_embed: int):
        super().__init__()
        self.coor_mlp0 = nn.Linear(d_embed, d_embed)
        self.coor_mlp1 = nn.Linear(d_embed, d_embed)
        self.coor_mlp2 = nn.Linear(d_embed, 3)
        self.conf_logits = nn.Linear(d_embed, 1)

    def forward(self, feats):
        h = F.relu(self.coor_mlp0(feats))
        h = F.relu(self.coor_mlp1(h))
        return self.coor_mlp2(h), self.conf_logits(feats)
