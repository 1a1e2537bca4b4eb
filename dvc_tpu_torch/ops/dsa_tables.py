"""The per-video tables of the LSTM-DSA word steps: ``table = x . w`` by the
hand-written 3xTF32 GEMM of ``csrc/dsa_gemm.cuh``, and its backward.

``dvc_dsa_greedy`` and ``dvc_dsa_scan_fwd``/``_bwd`` build their tables
(``value_t . Wc`` and ``embed . token_w``) with it inside every launch, so
their launch counts are its count on those paths.  The word-step kernels
(K7-K10) take ``VW = value_t . Wc`` as an operand: the caption head builds
it once per stepwise forward pass with :func:`dsa_value_table`, and its
backward runs once per backward pass.

* :func:`table_gemm` / :func:`table_gemm_bwd` — the kernels
  (``dvc_dsa_table_gemm``, ``dvc_dsa_table_gemm_bwd`` in
  ``csrc/dsa_tables.cu``) for CUDA tensors, the plain products
  (:func:`table_gemm_ref`, :func:`table_gemm_bwd_ref`) for CPU tensors;
  each counts its launches or calls.
* :func:`dsa_value_table` — ``VW`` (B, H, S, A), differentiable: on CUDA
  tensors an autograd Function over the two kernels, on CPU tensors the
  plain product under autograd.
"""

from __future__ import annotations

import torch

from . import _cuda


def table_gemm_ref(x, w):
    """Plain version: x (N, k) . w (k, n)."""
    table_gemm_ref.calls += 1
    return torch.einsum('nk,km->nm', x, w)


table_gemm_ref.calls = 0


def _f32_on_one_device(*tensors):
    dev = tensors[0].device
    if any(t.dtype != torch.float32 or t.device != dev for t in tensors):
        raise TypeError('the table GEMM takes float32 tensors on one device')


def table_gemm(x, w):
    """table (N, n) = x (N, k) . w (k, n), f32.  CPU tensors: the plain
    version.  CUDA tensors: the kernel, or an error."""
    if not x.is_cuda:
        return table_gemm_ref(x, w)
    _f32_on_one_device(x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f'table GEMM: shapes {tuple(x.shape)} and '
                         f'{tuple(w.shape)} do not chain')
    x, w = x.contiguous(), w.contiguous()
    (N, k), n = x.shape, w.shape[1]
    table = torch.empty((N, n), dtype=torch.float32, device=x.device)
    work = _cuda.gemm_work(x.device, (N, n, k))     # split-K partial tiles
    _cuda.check(_cuda.lib().cdll.dvc_dsa_table_gemm(
        x.data_ptr(), w.data_ptr(), table.data_ptr(), work.data_ptr(), N, k,
        n, work.numel(), _cuda.stream_ptr(x.device)), 'dvc_dsa_table_gemm')
    table_gemm.launches += 1
    return table


table_gemm.launches = 0


def table_gemm_bwd_ref(x, w, g):
    """Plain version of the backward: (g . w^T, x^T . g)."""
    table_gemm_bwd_ref.calls += 1
    return torch.einsum('nm,km->nk', g, w), torch.einsum('nk,nm->km', x, g)


table_gemm_bwd_ref.calls = 0


def table_gemm_bwd(x, w, g):
    """The gradients (dx (N, k), dw (k, n)) of table = x . w for its
    cotangent g (N, n), f32.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an error."""
    if not x.is_cuda:
        return table_gemm_bwd_ref(x, w, g)
    _f32_on_one_device(x, w, g)
    N, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k or tuple(g.shape) != (N, n):
        raise ValueError(f'table GEMM backward: shapes {tuple(x.shape)}, '
                         f'{tuple(w.shape)} and {tuple(g.shape)} do not chain')
    x, w, g = x.contiguous(), w.contiguous(), g.contiguous()
    dx = torch.empty((N, k), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=x.device)
    # the split-K partial tiles of dx = g . w^T and dw = x^T . g
    work = _cuda.gemm_work(x.device, (N, k, n), (k, n, N))
    _cuda.check(_cuda.lib().cdll.dvc_dsa_table_gemm_bwd(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), work.data_ptr(), N, k, n, work.numel(),
        _cuda.stream_ptr(x.device)), 'dvc_dsa_table_gemm_bwd')
    table_gemm_bwd.launches += 1
    return dx, dw


table_gemm_bwd.launches = 0


class ValueTable(torch.autograd.Function):
    """VW = value_t . cw by the table GEMM; its backward by the table
    GEMM's backward."""

    @staticmethod
    def forward(ctx, value_t, cw):
        ctx.save_for_backward(value_t, cw)
        B, H, S, Dh = value_t.shape
        return table_gemm(value_t.reshape(-1, Dh), cw).reshape(B, H, S, -1)

    @staticmethod
    def backward(ctx, g):
        value_t, cw = ctx.saved_tensors
        dx, dcw = table_gemm_bwd(value_t.reshape(-1, value_t.shape[-1]), cw,
                                 g.reshape(-1, cw.shape[1]))
        return dx.reshape(value_t.shape), dcw


def dsa_value_table(value_t, cw):
    """The per-video table VW = value_t (B, H, S, Dh) . cw (Dh, A) ->
    (B, H, S, A), differentiable.  CPU tensors: the plain product under
    autograd.  CUDA tensors: the table GEMM and, in the backward, its
    backward (each one launch), or an error."""
    if not value_t.is_cuda:
        B, H, S, Dh = value_t.shape
        return table_gemm_ref(value_t.reshape(-1, Dh), cw).reshape(B, H, S, -1)
    return ValueTable.apply(value_t, cw)
