"""GeoTransformer's geometric structure embedding: the CUDA kernel and its
plain PyTorch version.

    r[c, i, j] = proj_d(code(d_ij / sigma_d))
                 + max over x of proj_a(code(angle_x(i, j) * factor_a))

for every query row i and key j < the cloud's valid count, zeros at the
other keys.  d_ij = |p_j - p_i|; angle_x(i, j) is the angle between p_x -
p_i and p_j - p_i for the angle neighbours x of i (`knn`, (C, M, k), chosen
by the caller); code(v) is the d-wide sinusoidal code, sin and cos of v *
div interleaved; proj_d and proj_a are fp32 linears d -> d with bias.

Valid points are a prefix of each cloud.  The entries at padded keys reach
nothing: the self-attention (nn/geotransformer.py RPESelfAttentionLayer)
replaces every padded key's score, and each score reads only its own
key's entry.  So both versions write zeros there and the kernel skips
their work.

On a CUDA tensor `geo_embedding` launches csrc/geo_embedding.cu (the codes
made in registers, 3xTF32 products on the tensor cores by wgmma, the max
and the sum in registers, key tiles past the valid count not run) or
raises; only a
CPU tensor takes the plain version (`geo_embedding_reference`, which is
also what a kernel run is compared with on the card).  The kernel has no
backward: on a card the call raises where autograd would record it
(GeoTransformer runs inference only).  Each launch adds
one to `geo_embedding.launches`.  While a profiler runs,
`geo_embedding.tiles` sums on the device, with no host sync, the kernel's
key tiles (a block's 2 query rows x 64 keys x 128 columns) that computed
and those of its grid: an int64 pair (None until then; set it to None to
start again).

The kernel takes proj_d's and proj_a's weights split into TF32 big and
small parts in its shared-memory layout (`split_weight`); a caller passes a
dict that keeps each split while the weight's version, storage and device
stay the same.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import profiler_running
from .cuda_build import CudaLibrary

ANGLE_K = 3        # the kernel's angle neighbours
COL_TILE = 128     # output columns a block: d_model is a multiple
MAX_D = 1024
KEY_TILE = 64      # keys a block
QUERY_ROWS = 2     # query rows a block


def _declare(lib):
    lib.regtr_geo_embedding.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.regtr_geo_embedding.restype = ctypes.c_int


GEO_LIBRARY = CudaLibrary("geo_embedding.cu", _declare)


# ---------------------------------------------------------------- plain ---

def frequencies(d_model: int, device):
    """exp(-ln(1e4) 2m / d) for m < d / 2, fp32, computed on `device`."""
    return torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                  device=device)
                     * (-math.log(10000.0) / d_model))


def sinusoidal_embedding(x, d_model: int):
    """Upstream's SinusoidalPositionalEmbedding: x (...) -> (..., d), sin
    and cos interleaved, frequencies exp(-ln(1e4) 2m / d)."""
    omegas = x[..., None] * frequencies(d_model, x.device)
    return torch.stack([torch.sin(omegas), torch.cos(omegas)],
                       dim=-1).reshape(x.shape + (d_model,))


def pair_offsets(points):
    """points (C, M, 3) -> (p_j - p_i at [c, i, j] (C, M, M, 3), its squared
    length ((dx dx + dy dy) + dz dz) elementwise (C, M, M))."""
    diff = points[:, None, :, :] - points[:, :, None, :]
    dx, dy, dz = diff.unbind(-1)
    return diff, (dx * dx + dy * dy) + dz * dz


def embedding_codes(points, knn, d_model: int, sigma_d: float,
                    factor_a: float):
    """The plain version's fp32 codes, (C, M, M, d) each: the distances',
    then each angle neighbour's."""
    diff, sq = pair_offsets(points)
    yield sinusoidal_embedding(torch.sqrt(sq) / sigma_d, d_model)
    for x in range(knn.shape[-1]):
        ref = diff.gather(2, knn[..., x, None, None].expand(
            -1, -1, 1, 3))                                    # (C, M, 1, 3)
        sin = torch.linalg.norm(torch.cross(ref.expand_as(diff), diff,
                                            dim=-1), dim=-1)
        cos = (ref * diff).sum(-1)
        yield sinusoidal_embedding(torch.atan2(sin, cos) * factor_a, d_model)


def geo_embedding_reference(points, mask, knn, w_d, b_d, w_a, b_a,
                            sigma_d: float, factor_a: float):
    """The plain version: each code written out, then F.linear, the max
    over the angle neighbours and the sum; zeros at padded keys."""
    codes = embedding_codes(points, knn, w_d.shape[0], sigma_d, factor_a)
    out = F.linear(next(codes), w_d, b_d)
    angle = None
    for code in codes:
        emb = F.linear(code, w_a, b_a)
        angle = emb if angle is None else torch.maximum(angle, emb)
    return torch.where(mask[:, None, :, None], out + angle, 0.0)


# ---------------------------------------------------------------- kernel ---

def _tf32(x):
    """cvt.rna.tf32.f32's rounding (sm90_ptx.cuh `tf32_rna`) on fp32 bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_weight(w):
    """A linear's (d, d) fp32 weight W[n, k] as TF32 big and small parts in
    the kernel's layout: (d / 128 column tiles h, d / 64 chunks q, 2 parts
    (big, small), 8 k-steps s, 16 column groups r, 2 k halves e, 8 columns
    i, 4 kk), k-major core matrices of 8 columns x 4 k.  Entry [h, q, p, s,
    r, e, i, kk] is part p of W[128 h + 8 r + i, 64 q + 8 s + 2 kk + e]: a
    k-step's first half holds the sin columns of its 4 frequencies, the
    second their cos columns."""
    d = w.shape[0]
    big = _tf32(w)
    parts = torch.stack([big, _tf32(w - big)])
    parts = parts.reshape(2, d // COL_TILE, 16, 8, d // 64, 8, 4, 2)
    return parts.permute(1, 4, 0, 5, 2, 7, 3, 6).contiguous()


def _split(w, cache, name):
    key = (w._version, w.data_ptr(), w.device)
    entry = cache.get(name)
    if entry is None or entry[0] is not w or entry[1] != key:
        with torch.no_grad(), torch.inference_mode(False):
            entry = (w, key, split_weight(w.detach()))
        cache[name] = entry
    return entry[2]


def key_tile_counts(counts, m: int, d: int):
    """(key tiles the kernel computes, an int64 tensor on the counts'
    device (no host sync); key tiles of its grid, an int) for valid counts
    (C,) at extent m and width d."""
    per_key_tile = -(-m // QUERY_ROWS) * (d // COL_TILE)
    run = (counts.clamp(0, m).long() + KEY_TILE - 1).div(
        KEY_TILE, rounding_mode="floor").sum() * per_key_tile
    return run, counts.numel() * -(-m // KEY_TILE) * per_key_tile


def _count_tiles(counts, m, d):
    # normal tensors, even under inference_mode: a later call outside it
    # may add to them in place
    with torch.inference_mode(False):
        total = geo_embedding.tiles
        if total is None or total.device != counts.device:
            total = torch.zeros(2, dtype=torch.int64, device=counts.device)
            geo_embedding.tiles = total
        run, grid = key_tile_counts(counts, m, d)
        pair = torch.full((2,), grid, dtype=torch.int64, device=counts.device)
        pair[0] = run
        total.add_(pair)


def _check(points, mask, knn, w_d, b_d, w_a, b_a):
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (C, M, 3), got "
                         f"{tuple(points.shape)}")
    c, m, _ = points.shape
    if mask.shape != (c, m) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {(c, m)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if knn.shape != (c, m, ANGLE_K):
        raise ValueError(f"the kernel takes {ANGLE_K} angle neighbours: knn "
                         f"{tuple(knn.shape)} != {(c, m, ANGLE_K)}")
    if knn.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"knn must be int32 or int64, got {knn.dtype}")
    d = w_d.shape[0]
    if d % COL_TILE or not 0 < d <= MAX_D:
        raise ValueError(f"d_model {d} is not a multiple of {COL_TILE} up "
                         f"to {MAX_D}")
    for name, t, shape in (("w_d", w_d, (d, d)), ("w_a", w_a, (d, d)),
                           ("b_d", b_d, (d,)), ("b_a", b_a, (d,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if points.dtype != torch.float32:
        raise ValueError(f"points must be fp32, got {points.dtype}")
    if c * -(-m // QUERY_ROWS) > 65535:
        raise ValueError(f"{c} clouds x {m} rows exceed the kernel's grid")
    for name, t in (("mask", mask), ("knn", knn), ("w_d", w_d),
                    ("b_d", b_d), ("w_a", w_a), ("b_a", b_a)):
        if t.device != points.device:
            raise ValueError(f"{name} on {t.device}, expected "
                             f"{points.device}")


def _kernel(points, mask, knn, w_d, b_d, w_a, b_a, sigma_d, factor_a,
            cache):
    _check(points, mask, knn, w_d, b_d, w_a, b_a)
    c, m, _ = points.shape
    d = w_d.shape[0]
    points = points.contiguous()
    knn = knn.to(torch.int32).contiguous()
    counts = mask.sum(1, dtype=torch.int32)
    div = frequencies(d, points.device)
    wd, wa = _split(w_d, cache, "d"), _split(w_a, cache, "a")
    out = torch.empty((c, m, m, d), dtype=torch.float32,
                      device=points.device)
    # PyTorch's CUDA division by a scalar multiplies by its fp32 reciprocal
    inv_sigma_d = float(np.float32(1.0) / np.float32(sigma_d))
    with torch.cuda.device(points.device):
        err = GEO_LIBRARY.load().regtr_geo_embedding(
            points.data_ptr(), knn.data_ptr(), counts.data_ptr(),
            div.data_ptr(), wd.data_ptr(), b_d.data_ptr(), wa.data_ptr(),
            b_a.data_ptr(), out.data_ptr(), c, m, d, inv_sigma_d,
            float(factor_a),
            torch.cuda.current_stream(points.device).cuda_stream)
    GEO_LIBRARY.check(err, "geometric embedding")
    geo_embedding.launches += 1
    if profiler_running():
        _count_tiles(counts, m, d)
    return out


def geo_embedding(points, mask, knn, w_d, b_d, w_a, b_a, sigma_d: float,
                  factor_a: float, cache=None):
    """points (C, M, 3) fp32, mask (C, M) (valid points a prefix), knn (C,
    M, k) the angle neighbours, proj_d's and proj_a's weights and biases
    -> (C, M, M, d) fp32, zeros at padded keys.  `cache`: a dict that keeps
    the kernel's split weights between calls (a fresh one each call without
    it)."""
    if points.device.type == "cpu":
        return geo_embedding_reference(points, mask, knn, w_d, b_d, w_a, b_a,
                                       sigma_d, factor_a)
    if points.device.type != "cuda":
        raise ValueError(f"no geometric embedding for device "
                         f"{points.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (points, w_d, b_d, w_a, b_a)):
        raise ValueError("the embedding kernel has no backward: call it "
                         "under torch.no_grad() or torch.inference_mode()")
    return _kernel(points, mask, knn, w_d, b_d, w_a, b_a, sigma_d, factor_a,
                   {} if cache is None else cache)


geo_embedding.launches = 0
geo_embedding.tiles = None
