"""Masked flash attention: the CUDA kernel and its plain PyTorch version.

Counterpart of regtr_tpu/ops/pallas/attention.py (forward only).
`flash_masked_attention` keeps the JAX package's layout: q (BH, Nq, d),
k and v (BH, Nk, d), bias (BH, Nk) fp32, additive per key (0 for valid
keys, NEG_BIAS for masked ones).  On a CUDA tensor it launches the kernel in
csrc/flash_attn_fwd.cu, or raises; only a CPU tensor goes to the plain
version.

The kernel is compiled with nvcc at first use into `.build/` at the root of
the checkout (a plain C interface, loaded with ctypes), named by a hash of
its source and flags, so a changed source is rebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

NEG_BIAS = -1e9

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "flash_attn_fwd.cu"
BUILD_DIR = _PKG_DIR.parent / ".build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (16, 32, 64)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    """Where the built kernel library lives (named by source + flags)."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"flash_attn_fwd_{tag}.so"


def build_library() -> Path:
    """Compile the kernel if its library is missing; raise if nvcc fails.

    The compiler's output (ptxas register and spill counts) goes to a
    `.log` file beside the library.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.regtr_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.regtr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.regtr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_masked_attention_reference(q, k, v, bias, sm_scale: float):
    """Plain version: fp32 softmax(q k^T * scale + bias), p rounded to v's
    dtype, fp32 p*v product, result in q's dtype (the counterpart of the JAX
    package's `_xla_reference`)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = s + bias[:, None, :].float()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check(q, k, v, bias):
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
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            # the bf16 kernel moves pairs of values as 32-bit words
            raise ValueError(f"{name} must be 4-byte aligned")


def flash_masked_attention(q, k, v, bias, sm_scale: float):
    """softmax(q @ k^T * sm_scale + bias) @ v -> (BH, Nq, d) in q.dtype.

    CUDA tensors go through the hand-written kernel (and each launch adds
    one to `flash_masked_attention.launches`); CPU tensors through
    `flash_masked_attention_reference`.
    """
    if q.device.type == "cpu":
        return flash_masked_attention_reference(q, k, v, bias, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    _check(q, k, v, bias)
    lib = load_library()
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.regtr_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bh, nq, k.shape[1], d,
            int(q.dtype == torch.bfloat16), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("flash attention launch failed: "
                           + lib.regtr_cuda_error_string(err).decode())
    flash_masked_attention.launches += 1
    return out


flash_masked_attention.launches = 0
