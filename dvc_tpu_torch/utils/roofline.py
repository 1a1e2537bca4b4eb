"""Roofline accounting of a step: its FLOPs and least bytes, MFU and the
share of the card's speed of light (port of ``dvc_tpu/utils/roofline.py``).

JAX reads XLA's ``cost_analysis()`` of the jitted step.  PyTorch has no
such count, and ``torch.utils.flop_counter.FlopCounterMode`` alone would get
the step wrong: on the card it sees nothing of the hand-written kernels
(they launch through ``ctypes`` and never pass the dispatcher), and on the
CPU it counts their plain versions' forms (tables, recomputes), which are
not the kernels' work.  So :func:`step_costs` sums two parts:

(a) ``FlopCounterMode``'s count of the torch ops outside the hand-written
    ops (products and convolutions, 2 per multiply-add);
(b) each hand-written op's own count, charged by its wrapper
    (:func:`charged`) from a count function beside it in ``ops/``.

Inside every wrapper the counting mode is suspended, on the kernel branch
and on the plain-version branch alike (:meth:`Region.plain` carries the
suspension into the plain version's backward), so the CPU count and the
card count are one number.  A backward kernel charges at backward time, so
a train step's count holds the forward and the backward.

An op is counted by the least work of its function, not by any
implementation of it: the products and arithmetic of its JAX jnp oracle
(``ms_deform_attn_ref``, ``dsa_teacher_scan_ref`` and its VJP,
``dsa_greedy_scan_ref``, ``dsa_sample_attend_ref``, ``dsa_lstm_step_ref``
and their VJPs), except where the oracle takes a costlier form than it
needs: a tap is a gather and lerp, not the oracles' one-hot lerp matrix
times value_t, and the scores' taps . Wc (the decode's embed[it] .
token_w) take the cheaper of the direct and the table form at the call's
shapes (``dsa_scan.scores_flops``).  The convention: a product is 2 FLOPs
a multiply-add; each elementwise arithmetic primitive 1 FLOP an output
element; a reduction its input's size.  The tables the port builds (VW =
value . Wc, embed . token_w) charge nothing of their own: their work is
inside the word step's or the greedy decode's count.  The assignment
solver charges its cost matrix's bytes and no FLOPs.

A step's bytes are the least any implementation must move: the weights
read once (in a train step also written once, and two AdamW moments of
their size read and written once), the batch read once and the outputs
written once.  The eager ops' inputs and outputs are not summed: at B=16
most intermediates stay in the H100's 50 MB L2.

MFU is against the card's dense bf16 peak (JAX's convention, whatever
dtype the step computes in); the peaks are NVIDIA's data-sheet figures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's dense peak rates: FLOP/s in bf16, TF32 (tensor cores) and
    f32 (CUDA cores), and HBM bytes/s."""
    bf16: float
    tf32: float
    f32: float
    hbm: float


# NVIDIA's data sheets, dense (half the sheets' "with sparsity" tensor-core
# figures), at each part's full power limit
H100_SXM = Peaks(bf16=989e12, tf32=495e12, f32=67e12, hbm=3.35e12)
H100_PCIE = Peaks(bf16=756e12, tf32=378e12, f32=51e12, hbm=2.0e12)
H100_NVL = Peaks(bf16=835.5e12, tf32=417.5e12, f32=60e12, hbm=3.9e12)

# lowercase substring of torch.cuda.get_device_name -> peaks
_PEAKS = (
    ('h100 80gb hbm3', H100_SXM),
    ('h100 sxm', H100_SXM),
    ('h100 pcie', H100_PCIE),
    ('h100 nvl', H100_NVL),
)


def device_peaks(device=None):
    """The :class:`Peaks` of ``device`` (default: the first CUDA device) by
    its name in the data-sheet table, or None (the CPU, no card, a card not
    in the table)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = 0
    if isinstance(device, str):
        device = torch.device(device)
    if isinstance(device, torch.device):
        if device.type != 'cuda':
            return None
        device = device.index or 0
    name = torch.cuda.get_device_name(device).lower()
    return next((peaks for sub, peaks in _PEAKS if sub in name), None)


def device_peak(device=None):
    """(peak bf16 FLOP/s, HBM bytes/s) of ``device`` (:func:`device_peaks`),
    or None: JAX's ``device_peak``."""
    peaks = device_peaks(device)
    return None if peaks is None else (peaks.bf16, peaks.hbm)


def least_ms(n_bytes, flops, flop_rate, hbm=H100_SXM.hbm):
    """(least ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over ``flop_rate``; 'bytes' or 'operations'."""
    t_bytes = n_bytes / hbm * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    """Bytes of the tensors given (None entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# --------------------------------------------------------------------------
# the counting mode
# --------------------------------------------------------------------------

class StepCounter:
    """What one counted run charged: the FLOP counter of the torch ops
    outside the hand-written ops (``flop_counter``) and each hand-written
    op's own count (``ops``: name -> [flops, bytes, calls])."""

    def __init__(self):
        self.flop_counter = _Counting()
        self.ops = {}

    def charge(self, name, flops, n_bytes):
        entry = self.ops.setdefault(name, [0, 0, 0])
        entry[0] += flops
        entry[1] += n_bytes
        entry[2] += 1

    @property
    def torch_flops(self):
        return self.flop_counter.get_total_flops()

    @property
    def kernel_flops(self):
        return sum(e[0] for e in self.ops.values())


class _Counting(FlopCounterMode):
    """PyTorch's FLOP counter with no per-module breakdown: its module
    tracker hooks every module's inputs for autograd, which fails on a
    parameter inside ``torch.inference_mode`` (the eval step's)."""

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _WholeRun()


class _WholeRun:
    """A module tracker that files every count under 'Global'."""
    parents = ('Global',)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


# the StepCounter of the counted run (:func:`step_costs`); None outside one
# and inside a hand-written op's region, so an uncounted call, or one
# nested in another's, costs one read of it
_ACTIVE = None


class Region:
    """The inside of a :func:`charged` wrapper; ``counter`` is None outside
    a counted run."""

    def __init__(self, counter):
        self.counter = counter

    def plain(self, name, bwd_cost, fn, *args):
        """``fn(*args)``, a plain version whose backward is autograd through
        it.  In a counted run it goes through :class:`_PlainRegion`, whose
        backward charges ``bwd_cost`` (as :func:`charged` takes it, under
        ``name``) and keeps autograd's walk through ``fn`` out of the
        count."""
        tensors = [a for a in args if torch.is_tensor(a)]
        if (self.counter is None or not torch.is_grad_enabled()
                or not any(t.requires_grad for t in tensors)):
            return fn(*args)
        slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]

        def run(*ts):
            full = list(args)
            for i, t in zip(slots, ts):
                full[i] = t
            return fn(*full)
        out = _PlainRegion.apply(run, (name, bwd_cost), *tensors)
        return out[0] if len(out) == 1 else out


class _Idle:
    """:func:`charged` outside a counted run: a context that does
    nothing."""
    region = Region(None)

    def __enter__(self):
        return self.region

    def __exit__(self, *exc):
        return None


_IDLE = _Idle()


def charged(name, cost):
    """Charge a hand-written op to the counted run, if one is active:
    ``cost`` is (flops, bytes) or a function returning them, called only
    then.  The body runs with the counting mode suspended (nested charges
    are then no-ops).  A context that yields a :class:`Region`."""
    return _IDLE if _ACTIVE is None else _charging(name, cost)


@contextlib.contextmanager
def _charging(name, cost):
    global _ACTIVE
    from torch.utils._python_dispatch import _disable_current_modes
    counter = _ACTIVE
    counter.charge(name, *(cost() if callable(cost) else cost))
    _ACTIVE = None
    try:
        with _disable_current_modes():
            yield Region(counter)
    finally:
        _ACTIVE = counter


def charges(name, cost):
    """Decorator: each call of the function charges ``cost(*args,
    **kwargs)`` ((flops, bytes) of the same arguments; or ``cost`` itself,
    a constant pair) under ``name``, as :func:`charged` does."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if _ACTIVE is None:
                return fn(*args, **kwargs)
            with _charging(name, (lambda: cost(*args, **kwargs))
                           if callable(cost) else cost):
                return fn(*args, **kwargs)
        return counted
    return wrap


class _PlainRegion(torch.autograd.Function):
    """A plain version under autograd, run with its graph kept inside: the
    forward runs ``run`` on detached copies of the inputs, the backward is
    autograd through that graph inside a :func:`charged` region."""

    @staticmethod
    def forward(ctx, run, bwd, *tensors):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.requires_grad)
                  if t.is_floating_point() else t.detach() for t in tensors]
            outs = run(*xs)
        outs = (outs,) if torch.is_tensor(outs) else tuple(outs)
        ctx.xs, ctx.outs, ctx.bwd = xs, outs, bwd
        res = tuple(o.detach().clone() for o in outs)
        ctx.mark_non_differentiable(
            *[r for r, o in zip(res, outs) if o.grad_fn is None])
        return res

    @staticmethod
    def backward(ctx, *gs):
        name, cost = ctx.bwd
        with charged(name, cost):
            roots = [(o, g) for o, g in zip(ctx.outs, gs)
                     if o.grad_fn is not None and g is not None]
            wrt = [x for x in ctx.xs if x.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in roots], wrt, [g for _, g in roots],
                allow_unused=True) if roots and wrt else ())
            grads = [next(got) if x.requires_grad else None for x in ctx.xs]
        return (None, None, *grads)


def _tree_bytes(tree):
    """Bytes of the tensors and numpy arrays in a nest of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(x) for x in tree)
    return tree.nbytes if hasattr(tree, 'nbytes') and hasattr(
        tree, 'dtype') else 0


def step_costs(fn, *args, weights=(), train=False):
    """FLOPs and least bytes of one call ``fn(*args)``, run once on whatever
    device its arguments live on; the counterpart of JAX's
    ``compiled_costs``.  ``weights``: the model's parameters (read once; with
    ``train`` also written once, and two AdamW moments of each trainable
    one read and written once).  The batch is every tensor and numpy
    array in ``args``, the outputs every tensor ``fn`` returns.  Returns
    {'flops', 'bytes', 'source': 'counted', 'torch_flops', 'kernel_flops',
    'ops'} with ``ops`` each hand-written op's {name: (flops, bytes,
    calls)}."""
    global _ACTIVE
    counter, before = StepCounter(), _ACTIVE
    _ACTIVE = counter
    try:
        with counter.flop_counter:
            out = fn(*args)
    finally:
        _ACTIVE = before
    weights = list(weights)
    n_bytes = _tree_bytes(args) + _tree_bytes(out)
    n_bytes += nbytes(*weights)
    if train:
        n_bytes += nbytes(*weights)
        n_bytes += 4 * nbytes(*[w for w in weights if w.requires_grad])
    torch_flops = counter.torch_flops
    return {'flops': float(torch_flops + counter.kernel_flops),
            'bytes': float(n_bytes), 'source': 'counted',
            'torch_flops': float(torch_flops),
            'kernel_flops': float(counter.kernel_flops),
            'ops': {k: tuple(v) for k, v in counter.ops.items()}}


def roofline(costs, step_seconds, device=None):
    """Fold measured time + costs + card peaks into MFU/roofline fields
    (JAX's fields by JAX's arithmetic).  Returns a dict with flops/bytes
    echoed plus mfu, hbm_util, arithmetic_intensity, roofline_ms,
    roofline_pct; or None when costs or the card's peak are
    unavailable."""
    if not costs or not step_seconds or not math.isfinite(step_seconds):
        return None
    peak = device_peak(device)
    if peak is None:
        return None
    pf, bw = peak
    flops, byts = costs['flops'], costs.get('bytes')
    out = {
        'flops_per_step': flops,
        'bytes_per_step': byts,
        'mfu': round(flops / step_seconds / pf, 4),
        'peak_bf16_flops': pf,
        'hbm_bw': bw,
        'cost_source': costs.get('source', 'default'),
    }
    if byts:
        out['hbm_util'] = round(byts / step_seconds / bw, 4)
        out['arithmetic_intensity'] = round(flops / byts, 2)
        bound = max(flops / pf, byts / bw)
        out['roofline_ms'] = round(bound * 1e3, 3)
        out['roofline_pct'] = round(bound / step_seconds, 4)
    return out


def forward_flops(model, x):
    """torch.utils.flop_counter's count of one forward of ``model`` on x
    (its products and convolutions, 2 per multiply-add), under
    ``torch.inference_mode``."""
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(x)
    return counter.get_total_flops()
