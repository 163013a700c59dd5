"""Row and element gathers: the CUDA kernels (csrc/gather.cu) and their
plain PyTorch versions.

Counterpart of the TPU gather kernels of tools/exp_pallas_gather*.py.

* `row_gather(table, idx)`: out[r, :] = table[idx[r], :], the forward of
  every neighbor gather (ops/kpconv.py).  Plain version: `index_select`.
* `element_gather(src, idx, axis)`: out[..., i, j] = src[..., idx[..., i,
  j], j] (axis 0) or src[..., i, idx[..., i, j]] (axis 1) over the last two
  dimensions of a 2-D or batched 3-D tensor.  Plain version: `torch.gather`.
  The 'scan' and 'grid' neighbor searches (ops/neighbors.py) take their
  selected candidates' int32 ids with it.

A gather is a copy: the kernels move the source's bits, so they are bitwise
equal to their plain versions (the element gather moves int32 elements as
it moves fp32 ones: as 4-byte words, whatever their float view).  Indices
are in range: the kernels do not check or clamp them.  The row gather
takes int32 or int64 indices (the backbone's flat ids are int32,
ops/kpconv.py `GatherIndex`), the element gather int64.  On a CUDA tensor
each wrapper launches its kernel or raises; only a CPU tensor takes the
plain version.  Each launch adds one to the wrapper's `.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary

DTYPES = (torch.float32, torch.bfloat16)
ELEMENT_DTYPES = DTYPES + (torch.int32,)


def _declare(lib):
    lib.regtr_row_gather.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    lib.regtr_row_gather.restype = ctypes.c_int
    lib.regtr_element_gather.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int]
        + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.regtr_element_gather.restype = ctypes.c_int


GATHER_LIBRARY = CudaLibrary("gather.cu", _declare)


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version: (R_table, C) rows at idx (R,) -> (R, C)."""
    return table.index_select(0, idx)


def element_gather_reference(src: torch.Tensor, idx: torch.Tensor,
                             axis: int) -> torch.Tensor:
    """Plain version: torch.gather along axis 0 or 1 of the last two
    dimensions."""
    return torch.gather(src, src.dim() - 2 + axis, idx)


def _check_device(x: torch.Tensor, idx: torch.Tensor, what: str,
                  idx_dtypes=(torch.int64,), dtypes=DTYPES):
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {x.dtype} not one of {dtypes}")
    if idx.dtype not in idx_dtypes or idx.device != x.device:
        raise ValueError(f"{what}: indices must be "
                         f"{'/'.join(map(str, idx_dtypes))} on {x.device}")


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R_table, C) contiguous, fp32 or bf16; idx (R,) int32 or int64
    in [0, R_table) -> (R, C) in table's dtype."""
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    _check_device(table, idx, "row gather", (torch.int32, torch.int64))
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table (R, C) and idx (R,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("row gather: table and idx must be contiguous")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        err = GATHER_LIBRARY.load().regtr_row_gather(
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
            out.data_ptr(), idx.shape[0],
            table.shape[1] * table.element_size(),
            torch.cuda.current_stream(table.device).cuda_stream)
    GATHER_LIBRARY.check(err, "row gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def _slices(x: torch.Tensor, what: str):
    """A (R, C) or (B, R, C) tensor whose last two dimensions are
    contiguous -> (B, R, C, batch stride in elements)."""
    if x.dim() == 2:
        x = x[None]
    if x.dim() != 3 or x.stride(2) != 1 or x.stride(1) != x.shape[2]:
        raise ValueError(f"element gather: {what} must be (R, C) or (B, R, "
                         f"C) with its last two dimensions contiguous")
    return (*x.shape, x.stride(0))


def element_gather(src: torch.Tensor, idx: torch.Tensor, axis: int
                   ) -> torch.Tensor:
    """torch.gather(src, src.dim() - 2 + axis, idx) for a 2-D (R, C) or
    3-D (B, R, C) src, fp32, bf16 or int32, whose last two dimensions are
    contiguous and whose batch dimension has any stride; idx int64 of the
    output's shape, the same batch, and src's extent on the other axis."""
    if src.device.type == "cpu":
        return element_gather_reference(src, idx, axis)
    _check_device(src, idx, "element gather", dtypes=ELEMENT_DTYPES)
    if axis not in (0, 1) or src.dim() != idx.dim():
        raise ValueError(f"element gather: axis {axis}, src "
                         f"{tuple(src.shape)}, idx {tuple(idx.shape)}")
    sb, s_rows, s_cols, s_stride = _slices(src, "src")
    b, rows, cols, i_stride = _slices(idx, "idx")
    if sb != b or (axis == 0 and cols != s_cols) or (axis == 1
                                                      and rows != s_rows):
        raise ValueError(f"element gather along axis {axis}: src "
                         f"{tuple(src.shape)} and idx {tuple(idx.shape)}")
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        err = GATHER_LIBRARY.load().regtr_element_gather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, rows, cols,
            s_cols, axis, s_stride, i_stride, rows * cols,
            src.element_size(),
            torch.cuda.current_stream(src.device).cuda_stream)
    GATHER_LIBRARY.check(err, "element gather")
    element_gather.launches += 1
    return out


element_gather.launches = 0
