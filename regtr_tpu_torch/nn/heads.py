"""Correspondence heads (counterparts of regtr_tpu/nn/heads.py): the
regressor (`direct_regress_coor: True`, the shipped configs) and the
attention decoder (`direct_regress_coor: False`)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.masking import NEG_INF
from ..core.pairs import swap_pairs


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

    def forward(self, feats, xyz=None, pos=None, mask=None):
        h = F.relu(self.coor_mlp0(feats))
        h = F.relu(self.coor_mlp1(h))
        return self.coor_mlp2(h), self.conf_logits(feats)


class CorrespondenceDecoder(nn.Module):
    """Single-head attention into the partner cloud: q and k projections
    only, the partner's raw coordinates as values.

    feats (L, 2B, N, D), xyz (2B, N, 3), pos (2B, N, D), mask (2B, N) ->
    (corr (L, 2B, N, 3), overlap (L, 2B, N, 1)).  The dense (L, 2B, N, N)
    scores are fp32.  With num_neighbors in (0, N), each query keeps only
    the scores at least its num_neighbors-th largest (ties at that value
    all kept, as in the JAX package) before the softmax.
    """

    def __init__(self, d_embed: int, use_pos_emb: bool = True,
                 num_neighbors: int = 0):
        super().__init__()
        self.d_embed = d_embed
        self.use_pos_emb = use_pos_emb
        self.num_neighbors = num_neighbors
        self.q_proj = nn.Linear(d_embed, d_embed)
        self.k_proj = nn.Linear(d_embed, d_embed)
        self.conf_logits = nn.Linear(d_embed, 1)

    def forward(self, feats, xyz, pos, mask):
        feats_q = (feats + pos[None] if self.use_pos_emb and pos is not None
                   else feats)
        q = self.q_proj(feats_q) / math.sqrt(self.d_embed)
        k_partner = swap_pairs(self.k_proj(feats_q), dim=1)
        attn = q @ k_partner.transpose(-1, -2)               # (L,2B,N,N)
        attn = torch.where(swap_pairs(mask)[None, :, None, :], attn, NEG_INF)
        if 0 < self.num_neighbors < attn.shape[-1]:
            kth = torch.topk(attn, self.num_neighbors, dim=-1).values[
                ..., -1:]
            attn = torch.where(attn >= kth, attn, NEG_INF)
        corr = torch.softmax(attn, dim=-1) @ swap_pairs(xyz)
        return corr, self.conf_logits(feats)
