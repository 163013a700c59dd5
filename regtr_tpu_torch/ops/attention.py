"""Masked flash attention, forward and backward: the CUDA kernels and their
plain PyTorch versions.

Counterpart of regtr_tpu/ops/pallas/attention.py.  `flash_masked_attention`
keeps the JAX package's layout: q (BH, Nq, d), k and v (BH, Nk, d), bias
(BH, Nk) fp32, additive per key (0 for valid keys, NEG_BIAS for masked
ones).  It is differentiable (`torch.autograd.Function`, the counterpart of
the JAX custom_vjp):

* forward: csrc/flash_attn_fwd.cu; when the call is recorded for a backward
  it also writes lse = m + log(l) per query row, fp32 (BH, Nq);
* backward: delta = rowsum(dO * O) in PyTorch, as the JAX package computes
  it outside its kernels, then csrc/flash_attn_bwd.cu's dkv and dq kernels
  give dq, dk, dv and (when bias needs one) dbias.

On a CUDA tensor each step launches its kernel, or raises; only a CPU
tensor takes the plain versions (`flash_masked_attention_reference` and
`flash_masked_attention_bwd_reference`).  Each launch adds one to its
wrapper's count: `flash_masked_attention.launches` (forward),
`flash_attn_bwd_dkv.launches` and `flash_attn_bwd_dq.launches`.

`kv_extent`, optional, (BH,) int32 on q's device: one past the index of
each slice's last valid key (`key_extents`), 0 for a slice with none.  The
forward kernel then runs only the key tiles before it; every key at or past
it must carry NEG_BIAS.  The result is the same bit for bit, so the
backward and the plain versions take no notice of it.  While a profiler
runs, `flash_masked_attention.key_tiles` sums on the device, with no host
sync, the key tiles the forward kernel ran and those of its padded grid:
an int64 pair (None until then; set it to None to start again).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import profiler_running
from .cuda_build import CudaLibrary

NEG_BIAS = -1e9
HEAD_DIMS = (16, 32, 64)
BLOCK_Q = BLOCK_K = 64   # the forward kernel's query rows and keys a tile


def _declare_fwd(lib):
    lib.regtr_flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.regtr_flash_attn_fwd.restype = ctypes.c_int


def _declare_bwd(lib):
    lib.regtr_flash_attn_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.regtr_flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.regtr_flash_attn_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.regtr_flash_attn_bwd_dq.restype = ctypes.c_int


FWD_LIBRARY = CudaLibrary("flash_attn_fwd.cu", _declare_fwd)
BWD_LIBRARY = CudaLibrary("flash_attn_bwd.cu", _declare_bwd)


# ---------------------------------------------------------------- plain ---

def flash_masked_attention_reference(q, k, v, bias, sm_scale: float,
                                     return_lse: bool = False):
    """Plain version: fp32 softmax(q k^T * scale + bias), p rounded to v's
    dtype, fp32 p*v product, result in q's dtype (the counterpart of the JAX
    package's `_xla_reference`).  With return_lse, also the fp32 per-row
    logsumexp of the scores, (BH, Nq)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = s + bias[:, None, :].float()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = o.to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, (BH, Nq)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_masked_attention_bwd_reference(q, k, v, bias, o, lse, do,
                                         sm_scale: float):
    """Plain backward: the recompute of the JAX package's `_recompute_p_ds`
    with its roundings (p cast to dO's dtype before P^T dO, ds to q's dtype
    before dS^T Q and dS K; every product accumulated in fp32).

    Returns (dq, dk, dv in the operands' dtype, dbias fp32 (BH, Nk)).
    """
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = s + bias[:, None, :].float()
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - attention_delta(o, do)[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dsq = ds.to(q.dtype).float()
    dk = torch.einsum("bqk,bqd->bkd", dsq, q.float()) * sm_scale
    dq = torch.einsum("bqk,bkd->bqd", dsq, k.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=1)


def key_extents(mask, nhead: int = 1):
    """One past the index of each row's last True of a (B, N) key mask, 0
    for a row with none, as int32, each repeated `nhead` times: (B * nhead,),
    the slices of the attention's (B * nhead, N, d) layout.  Exact for any
    mask, a prefix or not."""
    n = mask.shape[1]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device)
    ext = (idx * mask).amax(dim=1)
    return ext[:, None].expand(-1, nhead).reshape(-1)


def key_tile_counts(kv_extent, bh: int, nq: int, nk: int):
    """(key tiles the forward kernel runs, key tiles of its padded grid)
    for one call: the first an int64 tensor on the extents' device (no host
    sync), or the int itself without extents; the second an int."""
    q_blocks = -(-nq // BLOCK_Q)
    grid = q_blocks * bh * -(-nk // BLOCK_K)
    if kv_extent is None:
        return grid, grid
    ext = torch.where(kv_extent > 0, kv_extent.clamp(max=nk), nk)
    return (ext.long() + BLOCK_K - 1).div(BLOCK_K, rounding_mode="floor") \
        .sum() * q_blocks, grid


# (kv_extent, (bh, nq, nk), its [run, grid] pair) of the latest extents:
# the encoder hands the same two tensors to every layer, so a forward
# computes each pair once and adds it 12 times, one launch a call
_TILE_PAIRS = []


def _count_key_tiles(kv_extent, bh, nq, nk, device):
    # normal tensors, even under inference_mode: a later call outside it
    # may add to them in place
    with torch.inference_mode(False):
        counts = flash_masked_attention.key_tiles
        if counts is None or counts.device != device:
            counts = torch.zeros(2, dtype=torch.int64, device=device)
            flash_masked_attention.key_tiles = counts
        dims = (bh, nq, nk)
        if kv_extent is None:
            counts.add_(key_tile_counts(None, *dims)[1])
            return
        pair = next((p for e, d, p in _TILE_PAIRS
                     if e is kv_extent and d == dims), None)
        if pair is None:
            run, grid = key_tile_counts(kv_extent, *dims)
            pair = torch.full((2,), grid, dtype=torch.int64, device=device)
            pair[0] = run
            _TILE_PAIRS[:] = _TILE_PAIRS[-3:] + [(kv_extent, dims, pair)]
        counts.add_(pair)


# --------------------------------------------------------------- kernels ---

def _check(q, k, v, bias, kv_extent=None):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 2:
        raise ValueError("expected q/k/v (BH, N, d) and bias (BH, Nk)")
    bh, nq, d = q.shape
    nk = k.shape[1]
    if k.shape != (bh, nk, d) or v.shape != (bh, nk, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bias.shape != (bh, nk):
        raise ValueError(f"bias {tuple(bias.shape)} != {(bh, nk)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if nq < 1 or nk < 1 or bh < 1 or bh > 65535:
        raise ValueError(f"unsupported sizes bh={bh} nq={nq} nk={nk}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand dtype {q.dtype} not fp32/bf16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be fp32, got {bias.dtype}")
    _check_tensors(q, q=q, k=k, v=v, bias=bias)
    if kv_extent is not None:
        if kv_extent.shape != (bh,) or kv_extent.dtype != torch.int32:
            raise ValueError(f"kv_extent must be int32 {(bh,)}, got "
                             f"{kv_extent.dtype} {tuple(kv_extent.shape)}")
        _check_tensors(q, kv_extent=kv_extent)


def _check_tensors(ref, **tensors):
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            # the bf16 kernels move pairs of values as 32-bit words
            raise ValueError(f"{name} must be 4-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _kernel_fwd(q, k, v, bias, sm_scale, want_lse, kv_extent=None):
    _check(q, k, v, bias, kv_extent)
    lib = FWD_LIBRARY.load()
    bh, nq, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        err = lib.regtr_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if kv_extent is None else kv_extent.data_ptr(), bh, nq, nk,
            d, int(q.dtype == torch.bfloat16), float(sm_scale), _stream(q))
    FWD_LIBRARY.check(err, "flash attention forward")
    flash_masked_attention.launches += 1
    if profiler_running():
        _count_key_tiles(kv_extent, bh, nq, nk, q.device)
    return out, lse


def _check_bwd(q, k, v, bias, do, lse, delta):
    _check(q, k, v, bias)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {tuple(q.shape[:2])}")
    _check_tensors(q, do=do, lse=lse, delta=delta)


def flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta, sm_scale: float,
                       want_dbias: bool):
    """The dkv kernel on CUDA tensors: (dk, dv, dbias fp32 or None)."""
    _check_bwd(q, k, v, bias, do, lse, delta)
    bh, nq, d = q.shape
    nk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = (torch.empty((bh, nk), dtype=torch.float32, device=q.device)
             if want_dbias else None)
    with torch.cuda.device(q.device):
        err = BWD_LIBRARY.load().regtr_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dbias is None else dbias.data_ptr(), bh,
            nq, nk, d, int(q.dtype == torch.bfloat16), float(sm_scale),
            _stream(q))
    BWD_LIBRARY.check(err, "flash attention backward (dk, dv)")
    flash_attn_bwd_dkv.launches += 1
    return dk, dv, dbias


flash_attn_bwd_dkv.launches = 0


def flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, sm_scale: float):
    """The dq kernel on CUDA tensors: dq."""
    _check_bwd(q, k, v, bias, do, lse, delta)
    bh, nq, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = BWD_LIBRARY.load().regtr_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, nq, k.shape[1], d, int(q.dtype == torch.bfloat16),
            float(sm_scale), _stream(q))
    BWD_LIBRARY.check(err, "flash attention backward (dq)")
    flash_attn_bwd_dq.launches += 1
    return dq


flash_attn_bwd_dq.launches = 0


# -------------------------------------------------------------- autograd ---

def _fwd(q, k, v, bias, sm_scale, want_lse, kv_extent=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_masked_attention_reference(q, k, v, bias, sm_scale,
                                                return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _kernel_fwd(q, k, v, bias, sm_scale, want_lse, kv_extent)


def _bwd(q, k, v, bias, o, lse, do, sm_scale, want_dbias):
    if q.device.type == "cpu":
        return flash_masked_attention_bwd_reference(q, k, v, bias, o, lse,
                                                    do, sm_scale)
    do = do.contiguous()
    delta = attention_delta(o, do)
    dk, dv, dbias = flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta,
                                       sm_scale, want_dbias)
    dq = flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, sm_scale)
    return dq, dk, dv, dbias


def _plain_fwd(q, k, v, bias, sm_scale, want_lse, kv_extent=None):
    return flash_masked_attention_reference(q, k, v, bias, sm_scale,
                                            return_lse=True)


def _plain_bwd(q, k, v, bias, o, lse, do, sm_scale, want_dbias):
    return flash_masked_attention_bwd_reference(q, k, v, bias, o, lse, do,
                                                sm_scale)


class _Attention(torch.autograd.Function):
    """One recorded attention call: `fwd` gives (out, lse), `bwd` the four
    gradients (the kernels, or the plain versions).  The key extents go to
    the forward only: its lse is the same bit for bit without them."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, fwd, bwd, kv_extent):
        out, lse = fwd(q, k, v, bias, sm_scale, True, kv_extent)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.sm_scale, ctx.bwd = sm_scale, bwd
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = ctx.bwd(q, k, v, bias, o, lse, do, ctx.sm_scale,
                                    ctx.needs_input_grad[3])
        if not ctx.needs_input_grad[3]:
            dbias = None
        return dq, dk, dv, dbias, None, None, None, None


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_masked_attention(q, k, v, bias, sm_scale: float, kv_extent=None):
    """softmax(q @ k^T * sm_scale + bias) @ v -> (BH, Nq, d) in q.dtype,
    differentiable in q, k, v and bias.

    CUDA tensors go through the hand-written kernels, CPU tensors through
    the plain versions.  Without a gradient to record, the forward skips
    the lse.  `kv_extent` (see the module) lets the forward kernel stop at
    each slice's last valid key.
    """
    if _needs_grad(q, k, v, bias):
        return _Attention.apply(q, k, v, bias, sm_scale, _fwd, _bwd,
                                kv_extent)
    return _fwd(q, k, v, bias, sm_scale, False, kv_extent)[0]


flash_masked_attention.launches = 0
flash_masked_attention.key_tiles = None


def flash_masked_attention_plain(q, k, v, bias, sm_scale: float,
                                 kv_extent=None):
    """The plain versions, forward and backward, on any device: what a
    kernel run is compared with.  `kv_extent` is taken and not used."""
    if _needs_grad(q, k, v, bias):
        return _Attention.apply(q, k, v, bias, sm_scale, _plain_fwd,
                                _plain_bwd, None)
    return flash_masked_attention_reference(q, k, v, bias, sm_scale)
