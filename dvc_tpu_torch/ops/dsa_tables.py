"""The per-video tables of the greedy decode (K6) and the scan backward
(K5): ``table = x . w`` by the hand-written tiled GEMM of
``csrc/dsa_common.cuh``.

``dvc_dsa_greedy`` and ``dvc_dsa_scan_bwd`` build their tables (``value_t .
Wc`` and ``embed . token_w``) with it inside every launch, so their launch
counts are its count on the main paths.  :func:`table_gemm` runs it alone,
so that it can be checked and timed: CUDA tensors go to the kernel
(``dvc_dsa_table_gemm`` in ``csrc/dsa_tables.cu``), CPU tensors to the
plain product.
"""

from __future__ import annotations

import torch

from . import _cuda


def table_gemm_ref(x, w):
    """Plain version: x (N, k) . w (k, n)."""
    table_gemm_ref.calls += 1
    return torch.einsum('nk,km->nm', x, w)


table_gemm_ref.calls = 0


def table_gemm(x, w):
    """table (N, n) = x (N, k) . w (k, n), f32.  CPU tensors: the plain
    version.  CUDA tensors: the kernel, or an error."""
    if not x.is_cuda:
        return table_gemm_ref(x, w)
    if (x.dtype != torch.float32 or w.dtype != torch.float32
            or w.device != x.device):
        raise TypeError('the table GEMM takes float32 tensors on one device')
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f'table GEMM: shapes {tuple(x.shape)} and '
                         f'{tuple(w.shape)} do not chain')
    x, w = x.contiguous(), w.contiguous()
    table = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                        device=x.device)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_table_gemm(
        x.data_ptr(), w.data_ptr(), table.data_ptr(), x.shape[0], x.shape[1],
        w.shape[1], _cuda.stream_ptr(x.device)), 'dvc_dsa_table_gemm')
    table_gemm.launches += 1
    return table


table_gemm.launches = 0
