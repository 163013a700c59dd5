"""Cross-attention transformer encoder over paired clouds (counterpart of
regtr_tpu/nn/transformer.py, inference forward).

Self-attention runs over the whole interleaved batch of 2B clouds;
cross-attention is the same attention with keys and values from the partner
cloud, i.e. the batch with adjacent slots swapped (core/pairs.py).

`record_attention(model)` is the attention-map hook (the JAX modules'
sow("intermediates", "attn")): inside it, every MultiHeadAttention also
recomputes its probabilities explicitly and records them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.masking import NEG_INF
from ..core.pairs import swap_pairs
from ..ops.attention import flash_masked_attention

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    """Masked multi-head attention, (B, N, D) layout, separate q/k/v/out
    projections.  Attention goes through `flash_masked_attention`: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors.

    Only the q/k/v operands are cast to `compute_dtype`; every projection,
    out_proj included, runs in fp32 (on the bf16-rounded attention output),
    as flax promotes a bf16 input to its fp32 parameters.

    While `record_attention` holds it, `record_to` is (maps, name) and each
    call also stores maps[name], its probabilities (see there).
    """

    def __init__(self, d_model: int, nhead: int, compute_dtype=None):
        super().__init__()
        self.nhead = nhead
        self.compute_dtype = compute_dtype
        self.record_to = None
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_mask):
        b, nq, d_model = q.shape
        nk = k.shape[1]
        h = self.nhead
        d_head = d_model // h
        op_dtype = self.compute_dtype or q.dtype

        qh, kh, vh = (proj(x).reshape(b, -1, h, d_head) for x, proj in (
            (q, self.q_proj), (k, self.k_proj), (v, self.v_proj)))

        def fold(y):
            y = y.transpose(1, 2).reshape(b * h, -1, d_head)
            return y.to(op_dtype).contiguous()

        scale = 1.0 / float(d_head) ** 0.5
        bias = torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)
        bias = bias[:, None, :].expand(b, h, nk).reshape(b * h, nk)
        o = flash_masked_attention(fold(qh), fold(kh), fold(vh),
                                   bias.contiguous(), scale)
        if self.record_to is not None:
            maps, name = self.record_to
            maps[name] = attention_probabilities(qh, kh, key_mask, scale)
        out = o.reshape(b, h, nq, d_head).transpose(1, 2).reshape(b, nq,
                                                                  d_model)
        return self.out_proj(out.float())


def attention_probabilities(qh, kh, key_mask, scale):
    """softmax(q.k^T * scale) over the valid keys, in fp32 from the fp32
    projections: (B, N, H, d) x2, (B, Nk) -> (B, H, N, Nk)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    logits = torch.where(key_mask[:, None, None, :], logits, NEG_INF)
    return torch.softmax(logits, dim=-1)


@contextlib.contextmanager
def record_attention(model: nn.Module):
    """Inside the context, each MultiHeadAttention of `model` records the
    attention probabilities of its latest call (B clouds, heads, N, Nk, at
    the padded capacity) in the yielded dict, under its module path with
    "/" for "." (e.g. "transformer_encoder/layer_0/self_attn", as the JAX
    demo names its sown maps).  The attention itself still runs through
    `flash_masked_attention`, so the outputs do not change; the maps are
    one explicit softmax each, paid only here."""
    maps = {}
    mods = [(name.replace(".", "/"), m) for name, m in model.named_modules()
            if isinstance(m, MultiHeadAttention)]
    for name, m in mods:
        m.record_to = (maps, name)
    try:
        yield maps
    finally:
        for _, m in mods:
            m.record_to = None


class CrossEncoderLayer(nn.Module):
    """Self-attn + cross-attn + FFN with weights shared by both clouds;
    pre-norm (the shipped configs) or post-norm."""

    def __init__(self, d_model, nhead, d_feedforward=1024, activation="relu",
                 pre_norm=True, sa_val_has_pos_emb=True,
                 ca_val_has_pos_emb=True, compute_dtype=None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {activation}")
        self.activation = activation
        self.pre_norm = pre_norm
        self.sa_val_has_pos_emb = sa_val_has_pos_emb
        self.ca_val_has_pos_emb = ca_val_has_pos_emb
        self.self_attn = MultiHeadAttention(d_model, nhead, compute_dtype)
        self.cross_attn = MultiHeadAttention(d_model, nhead, compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_feedforward)
        self.linear2 = nn.Linear(d_feedforward, d_model)

    def _ffn(self, x):
        h = self.linear1(x)
        # flax's nn.gelu defaults to the tanh approximation.
        h = F.relu(h) if self.activation == "relu" else F.gelu(
            h, approximate="tanh")
        return self.linear2(h)

    def forward(self, x, pos, mask):
        """x (2B, N, D) paired features, pos (2B, N, D) or None,
        mask (2B, N)."""
        def with_pos(t):
            return t if pos is None else t + pos

        kv_mask = swap_pairs(mask)
        if self.pre_norm:
            x2 = self.norm1(x)
            qk = with_pos(x2)
            x = x + self.self_attn(qk, qk, qk if self.sa_val_has_pos_emb
                                   else x2, mask)
            x2 = self.norm2(x)
            x2_w_pos = with_pos(x2)
            kv_w_pos = swap_pairs(x2_w_pos)
            v = kv_w_pos if self.ca_val_has_pos_emb else swap_pairs(x2)
            x = x + self.cross_attn(x2_w_pos, kv_w_pos, v, kv_mask)
            return x + self._ffn(self.norm3(x))
        qk = with_pos(x)
        x = self.norm1(x + self.self_attn(
            qk, qk, qk if self.sa_val_has_pos_emb else x, mask))
        x_w_pos = with_pos(x)
        kv_w_pos = swap_pairs(x_w_pos)
        v = kv_w_pos if self.ca_val_has_pos_emb else swap_pairs(x)
        x = self.norm2(x + self.cross_attn(x_w_pos, kv_w_pos, v, kv_mask))
        return self.norm3(x + self._ffn(x))


class TransformerCrossEncoder(nn.Module):
    """Stack of cross-encoder layers -> all per-layer outputs
    (L, 2B, N, D), each through the final norm when pre-norm."""

    def __init__(self, d_model, nhead, num_layers, d_feedforward=1024,
                 activation="relu", pre_norm=True, sa_val_has_pos_emb=True,
                 ca_val_has_pos_emb=True, compute_dtype=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", CrossEncoderLayer(
                d_model, nhead, d_feedforward, activation, pre_norm,
                sa_val_has_pos_emb, ca_val_has_pos_emb, compute_dtype))
        self.norm_final = (nn.LayerNorm(d_model, eps=LN_EPS) if pre_norm
                           else None)

    def forward(self, x, pos, mask):
        intermediates = []
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, pos, mask)
            intermediates.append(self.norm_final(x)
                                 if self.norm_final is not None else x)
        return torch.stack(intermediates, dim=0)
