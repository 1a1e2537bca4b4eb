"""The plan of the port's shared GEMM (``dsa::gemm``, csrc/dsa_gemm.cuh):
the tile and the split-K chunks that it picks from the shape
(csrc/dsa_gemm_plan.h), and the workspace that the wrappers give each
launch (``_cuda.gemm_work_floats``, which asks the same C rule through
``dvc_dsa_gemm_work_floats``).  The rule is plain C++; these checks build
csrc/dsa_gemm_plan.cc with the host's C++ compiler and run it on the CPU.
``tests/test_torch_cuda_kernels.py`` (marker ``cuda``) checks on the card
that the kernel takes exactly that workspace and refuses one float less.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest

from dvc_tpu_torch.ops import _cuda

SMS = 132           # an H100 SXM; 114: an H100 PCIe
B1_SCAN, B16_SCAN = 1 * 29 * 90, 16 * 29 * 90       # (video, step, query) rows


def _constant(name):
    with open(os.path.join(_cuda.CSRC, 'dsa_gemm_plan.h')) as f:
        return int(re.search(rf'constexpr int {name} = (\d+);', f.read())[1])


BK, MIN_SLICES, MAX_SLICES = (_constant(c) for c in (
    'kGemmBK', 'kGemmMinSlices', 'kGemmMaxSlices'))


@pytest.fixture(scope='module')
def plan_lib(tmp_path_factory):
    """csrc/dsa_gemm_plan.cc built alone by the host's C++ compiler."""
    cxx = shutil.which('c++') or shutil.which('g++')
    if cxx is None:
        pytest.skip('no host C++ compiler')
    path = str(tmp_path_factory.mktemp('plan') / 'libplan.so')
    subprocess.run([cxx, '-std=c++17', '-O2', '-shared', '-fPIC', '-o', path,
                    os.path.join(_cuda.CSRC, 'dsa_gemm_plan.cc')], check=True)
    return _cuda.bind(ctypes.CDLL(path),
                      ['dvc_dsa_gemm_work_floats', 'dvc_dsa_gemm_plan'])


@pytest.fixture
def c_rule(plan_lib, monkeypatch):
    """``_cuda`` answering from the C rule built for the CPU."""
    monkeypatch.setattr(_cuda, '_LIB', _cuda.KernelLib(plan_lib, '', 0.0, ''))
    _cuda.gemm_work_floats.cache_clear()
    yield plan_lib
    _cuda.gemm_work_floats.cache_clear()


def _plan(lib, M, N, T, sms=SMS):
    """(128 x 128 tiles?, chunks, terms a chunk) of the C rule."""
    out = (ctypes.c_int * 3)()
    lib.dvc_dsa_gemm_plan(M, N, T, sms, out)
    return bool(out[0]), out[1], out[2]


def _launch_gemms(B, H=1, S=375, d=512, A=512, R=512, LP=16, V1=1608, E=512,
                  K=29, Q=90, Qs=100):
    """The GEMMs (M, N, T) of each launch, at the recipe's widths, in the
    order of their call sites in csrc/."""
    Dh, BHS = d // H, B * H * S
    rows, steps = B * K * Q, B * Qs
    return {
        'table forward': [(BHS, A, Dh)],
        'table backward': [(BHS, Dh, A), (Dh, A, BHS)],
        'scan forward (K4)': [(BHS, A, Dh)],
        'scan backward (K5)': [(BHS, A, Dh), (BHS, Dh, A), (R, 4 * R, rows),
                               (H * Dh, 4 * R, rows), (R, A, rows),
                               (R, H * LP, rows), (Dh, A, BHS)],
        'greedy (K6)': [(BHS, A, Dh), (V1, 4 * R, E)],
        'word-step backward (K8)': [(BHS, A, Dh), (BHS, Dh, A), (Dh, A, BHS)],
        'lstm step backward (K10)': [(R, 4 * R, steps), (H * Dh, 4 * R, steps)],
    }


LAUNCHES = [(name, B) for B in (1, 16) for name in _launch_gemms(B)]
# the shapes of chip_smoke.py's [kernels] outer_sum lines
OUTER_SUMS = [(512, 2048, B16_SCAN), (512, 512, B16_SCAN), (512, 16, B16_SCAN),
              (512, 512, 6000), (512, 2048, 1600), (512, 2048, B1_SCAN)]


@pytest.mark.parametrize('name,B', LAUNCHES,
                         ids=[f'{n} B={B}' for n, B in LAUNCHES])
def test_workspace_covers_every_split_of_a_launch(c_rule, name, B):
    """One workspace serves a launch's GEMMs one after another (at
    cap_nheads 1 and 8, on 132 and 114 SMs): it holds the partial tiles of
    every split GEMM, a split's chunks are whole slices that cover the terms
    with none empty and none longer than kGemmMaxSlices slices (the
    accumulation error grows with a chunk's length), and a launch whose
    GEMMs are none of them split asks for one float (a pointer that is
    never null)."""
    for H in (1, 8):
        gemms = _launch_gemms(B, H)[name]
        for sms in (SMS, 114):
            floats = _cuda.gemm_work_floats(sms, *gemms)
            needs = [1]
            for M, N, T in gemms:
                _, splits, chunk = _plan(c_rule, M, N, T, sms)
                assert splits >= 1 and chunk % BK == 0, (M, N, T)
                assert chunk <= MAX_SLICES * BK, (M, N, T, chunk)
                assert splits * chunk >= T > (splits - 1) * chunk or T == 0
                if splits > 1:
                    assert chunk >= MIN_SLICES * BK, (M, N, T, chunk)
                    assert floats >= splits * M * N, (M, N, T, splits)
                    needs.append(splits * M * N)
            assert floats == max(needs), (H, sms)


@pytest.mark.parametrize('M,N,T', OUTER_SUMS)
def test_outer_sums_fill_the_card(c_rule, M, N, T):
    """The outer sums at their phase-3 shapes run at least one block an SM,
    in waves of two blocks an SM (the 128 x 128 tiles' occupancy) whose
    last is at least 90% full: one wave, or whole multiples of one where
    the chunks' length cap asks for more."""
    large, splits, _ = _plan(c_rule, M, N, T)
    side = 128 if large else 64
    blocks = -(-M // side) * -(-N // side) * splits
    waves = blocks / (2 * SMS)
    assert blocks >= SMS and waves / -(-blocks // (2 * SMS)) >= 0.9, (
        large, splits, blocks)


@pytest.mark.parametrize('M,N,T,large,splits', [
    (375, 512, 512, False, 4),          # the table at B=1: 48 tiles, split
    (6000, 512, 512, True, 1),          # B=16: 188 tiles of 128 x 128
    (48000, 512, 64, True, 1),          # H=8: two slices, no split
    (1608, 2048, 512, True, 1),         # embed . token_w
    (64, 512, 48000, False, 33),        # dw at H=8: 8 tiles, 33 chunks
    (512, 2048, B16_SCAN, True, 24),    # K5's h^T dz: 6 x 4 chunks, capped
    (512, 512, B16_SCAN, True, 32),     # K5's h^T dhvec: 2 x 16
    (512, 2048, B1_SCAN, True, 4),      # K5's h^T dz at B=1
    (512, 2048, 90, False, 1),          # K10 at B=1: three slices
    (5, 3, 0, False, 1),                # no terms: zeros, one launch
])
def test_plan_at_the_main_shapes(c_rule, M, N, T, large, splits):
    """The tile and the split that the rule picks at the main path's
    shapes (the B=1 table: 64 x 64 tiles and four chunks, where 128 x 128
    tiles made 12 blocks for 132 SMs; K5's outer sums at B=16: chunks of
    at most kGemmMaxSlices slices, in multiples of the one-wave split)."""
    assert _plan(c_rule, M, N, T)[:2] == (large, splits)


def test_no_workspace_for_unsplit_gemms(c_rule):
    """No split, no partial tiles: the C rule asks for none (an empty
    output or a negative term count neither), and a launch gets one float."""
    for M, N, T in ((48000, 512, 64), (6000, 512, 512), (0, 512, 512),
                    (512, 0, 512), (512, 512, -1)):
        assert c_rule.dvc_dsa_gemm_work_floats(M, N, T, SMS) == 0, (M, N, T)
    assert _cuda.gemm_work_floats(SMS, (48000, 512, 64), (6000, 512, 512)) == 1
    assert _cuda.gemm_work_floats(SMS) == 1
