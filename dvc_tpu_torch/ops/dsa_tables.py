"""The per-video tables of the LSTM-DSA word steps: ``table = x . w`` by the
hand-written 3xTF32 GEMM of ``csrc/dsa_gemm.cuh``, and its backward.

``dvc_dsa_greedy`` and ``dvc_dsa_scan_fwd``/``_bwd`` build their tables
(``value_t . Wc`` and ``embed . token_w``) with it inside every launch, so
their launch counts are its count on those paths.  The word-step kernels
(K7-K10 in f32, K9/K10 in bf16) take ``VW = value_t . Wc`` as an operand:
the caption head builds it once per stepwise forward pass with
:func:`dsa_value_table`, and its backward runs once per backward pass.

* :func:`table_gemm` / :func:`table_gemm_bwd` — the kernels
  (``dvc_dsa_table_gemm``, ``dvc_dsa_table_gemm_bwd`` in
  ``csrc/dsa_tables.cu``) for CUDA tensors, the plain products
  (:func:`table_gemm_ref`, :func:`table_gemm_bwd_ref`) for CPU tensors;
  each counts its launches or calls.
* :func:`dsa_value_table` — ``VW`` (B, H, S, A), differentiable: on CUDA
  tensors an autograd Function over the two kernels, on CPU tensors the
  plain product under autograd.

``precision='bfloat16'`` (the fused word step under ``--tpu_compute_dtype
bfloat16``, K9/K10-bf16): the GEMM's bf16-operand mode, every product on
bf16-rounded operands with f32 accumulation, so VW = bf16(value_t) .
bf16(cw) and its backward bf16(G) . bf16(cw)^T and bf16(value_t)^T .
bf16(G); the kernels count these launches apart (``launches_bf16``), and
on CPU tensors :func:`dsa_value_table` joins the plain bf16 products in an
autograd Function (autograd through a rounded product would not round the
backward's operands).
"""

from __future__ import annotations

import torch

from . import _cuda
from .dsa_bf16 import bf16, bf16_operand
from .dsa_greedy import check_precision


def table_gemm_ref(x, w, precision='float32'):
    """Plain version: x (N, k) . w (k, n), on bf16-rounded operands under
    ``precision='bfloat16'``."""
    table_gemm_ref.calls += 1
    if check_precision(precision):
        x, w = bf16(x), bf16(w)
    return torch.einsum('nk,km->nm', x, w)


table_gemm_ref.calls = 0


def _on_one_device(rb, *tensors):
    """Refuse what the table GEMM does not take: float32 tensors on one
    device, or under bf16 (``rb``) also torch.bfloat16 ones, which its bf16
    mode reads as they are stored.  Returns the ``bf16`` flags of the C
    entry (``_cuda.bf16_flags``; 0 in f32)."""
    dev = tensors[0].device
    types = (torch.float32, torch.bfloat16) if rb else (torch.float32,)
    if any(t.dtype not in types or t.device != dev for t in tensors):
        raise TypeError('the table GEMM takes float32 tensors on one device '
                        '(in bf16 also bfloat16 ones)')
    return _cuda.bf16_flags(*tensors) if rb else 0


def table_gemm(x, w, precision='float32'):
    """table (N, n) = x (N, k) . w (k, n), f32 (``precision='bfloat16'``:
    on bf16-rounded operands, each given as float32 or torch.bfloat16).
    CPU tensors: the plain version.  CUDA tensors: the kernel, or an
    error."""
    rb = check_precision(precision)
    if not x.is_cuda:
        return table_gemm_ref(x, w, precision)
    flags = _on_one_device(rb, x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f'table GEMM: shapes {tuple(x.shape)} and '
                         f'{tuple(w.shape)} do not chain')
    x, w = x.contiguous(), w.contiguous()
    (N, k), n = x.shape, w.shape[1]
    table = torch.empty((N, n), dtype=torch.float32, device=x.device)
    work = _cuda.gemm_work(x.device, (N, n, k))     # split-K partial tiles
    _cuda.check(_cuda.lib().cdll.dvc_dsa_table_gemm(
        x.data_ptr(), w.data_ptr(), table.data_ptr(), work.data_ptr(), N, k,
        n, work.numel(), flags, _cuda.stream_ptr(x.device)),
        'dvc_dsa_table_gemm')
    _cuda.count_launch(table_gemm, rb)
    return table


table_gemm.launches = 0
table_gemm.launches_bf16 = 0


def table_gemm_bwd_ref(x, w, g, precision='float32'):
    """Plain version of the backward: (g . w^T, x^T . g), on bf16-rounded
    operands under ``precision='bfloat16'``."""
    table_gemm_bwd_ref.calls += 1
    if check_precision(precision):
        x, w, g = bf16(x), bf16(w), bf16(g)
    return torch.einsum('nm,km->nk', g, w), torch.einsum('nk,nm->km', x, g)


table_gemm_bwd_ref.calls = 0


def table_gemm_bwd(x, w, g, precision='float32'):
    """The gradients (dx (N, k), dw (k, n)) of table = x . w for its
    cotangent g (N, n), f32 (``precision='bfloat16'``: on bf16-rounded
    operands).  CPU tensors: the plain version.  CUDA tensors: the kernel,
    or an error."""
    rb = check_precision(precision)
    if not x.is_cuda:
        return table_gemm_bwd_ref(x, w, g, precision)
    flags = _on_one_device(rb, x, w, g)
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
        dw.data_ptr(), work.data_ptr(), N, k, n, work.numel(), flags,
        _cuda.stream_ptr(x.device)), 'dvc_dsa_table_gemm_bwd')
    _cuda.count_launch(table_gemm_bwd, rb)
    return dx, dw


table_gemm_bwd.launches = 0
table_gemm_bwd.launches_bf16 = 0


class ValueTable(torch.autograd.Function):
    """VW = value_t . cw by the table GEMM; its backward by the table
    GEMM's backward; the last arguments are the precision and value_t in
    torch.bfloat16 or None.  In bf16 on the card the GEMMs read bf16:
    value_t's given copy (else one made here), cw and the cotangent G
    (summed in f32 over the word steps) rounded once each here."""

    @staticmethod
    def forward(ctx, value_t, cw, precision, value16=None):
        ctx.precision = precision
        B, H, S, Dh = value_t.shape
        x, w = value_t.reshape(-1, Dh), cw
        if value_t.is_cuda and check_precision(precision):
            x = (bf16_operand(x) if value16 is None
                 else value16.reshape(-1, Dh))
            w = bf16_operand(cw)
        ctx.save_for_backward(x, w)
        ctx.shape, ctx.dtypes = value_t.shape, (value_t.dtype, cw.dtype)
        return table_gemm(x, w, precision).reshape(B, H, S, -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, w.shape[1])
        if x.dtype == torch.bfloat16:
            g = bf16_operand(g)
        dx, dcw = table_gemm_bwd(x, w, g, ctx.precision)
        return (dx.reshape(ctx.shape).to(ctx.dtypes[0]), dcw.to(ctx.dtypes[1]),
                None, None)


def dsa_value_table(value_t, cw, precision='float32', value16=None):
    """The per-video table VW = value_t (B, H, S, Dh) . cw (Dh, A) ->
    (B, H, S, A), differentiable (``precision='bfloat16'``: on
    bf16-rounded operands, forward and backward; value16, value_t in
    torch.bfloat16, spares the card a rounding of it).  CPU tensors: the
    plain product under autograd (bf16: the plain bf16 products in
    :class:`ValueTable`).  CUDA tensors: the table GEMM and, in the
    backward, its backward (each one launch, and in bf16 a rounding of cw
    and one of G), or an error."""
    if not value_t.is_cuda and not check_precision(precision):
        B, H, S, Dh = value_t.shape
        return table_gemm_ref(value_t.reshape(-1, Dh), cw).reshape(B, H, S, -1)
    return ValueTable.apply(value_t, cw, precision, value16)
