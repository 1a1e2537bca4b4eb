"""On-device rectangular linear assignment (port of
``dvc_tpu/ops/assignment.py``): the Jonker-Volgenant shortest augmenting
path that matches gt events to queries in every (decoder layer, video) of a
step, by the hand-written kernel of ``csrc/assignment.cu`` on the card, so
the matcher's indices never visit the host.

* :func:`assignment` — the wrapper: the kernel (``dvc_assignment``) for
  CUDA tensors, one launch for every problem of a call
  (``assignment.launches``); :func:`assignment_ref` for CPU tensors.
* :func:`linear_sum_assignment_ref` — the plain version of JAX's
  ``linear_sum_assignment``, operation for operation in f32 (so its
  col4row is JAX's bit for bit, ties included), vectorised over problems
  as JAX's vmap runs them; counts its calls.
* :func:`masked_assignment` and :func:`many_to_one_assignment` — JAX's
  functions of those names on the wrapper.

Layout: cost (..., R, C), rows the gt slots and columns the queries, with
a row mask (the real slots).  Where R <= C the semantics are JAX's
``masked_assignment``: padded rows read as 0, non-finite entries as JAX's
``nan_to_num`` (nan and +inf 1e9, -inf -1e9), and all R rows solved, each
with a distinct column.  JAX refuses R > C; every anet recipe has it (30
gt slots against 10 queries), so the port decides per problem from its n
real rows: n <= C solves the real rows in slot order and gives the padded
slots the unused columns in ascending order while any are left, then -1;
n > C solves the transposed problem (a real slot for each column) and
leaves the unchosen slots and the padded ones at -1.  Either way the total
cost is the optimum scipy finds.
"""

from __future__ import annotations

import torch

from ..utils.roofline import charges, nbytes
from . import _cuda

_INF = float('inf')


def _argmin(x):
    """jnp.argmin over the last axis: the first NaN where there is one,
    else the first least value."""
    nan = torch.isnan(x)
    least = torch.where(nan, _INF, x).amin(-1, keepdim=True)
    first = (x == least).int().argmax(-1)
    return torch.where(nan.any(-1), nan.int().argmax(-1), first)


def linear_sum_assignment_ref(cost, n_rows=None, n_cols=None,
                              with_steps=False):
    """Plain version of JAX's ``linear_sum_assignment`` on cost (P, R, C),
    R <= C, in f32: col4row (P, R) int64.  ``n_rows`` / ``n_cols`` (P,)
    give each problem a top-left (n_rows, n_cols) block of its own (rows
    and columns beyond it are not read; those rows get -1), as the port's
    R > C rules need.  ``with_steps``: also the Dijkstra steps each problem
    ran (P,) int32, as the kernel counts them."""
    linear_sum_assignment_ref.calls += 1
    P, R, C = cost.shape
    dev = cost.device
    if n_rows is None and R > C:
        raise ValueError(f'need R <= C, got {tuple(cost.shape)}')
    cost = cost.float()
    n_rows = (torch.full((P,), R, device=dev) if n_rows is None else n_rows)
    n_cols = (torch.full((P,), C, device=dev) if n_cols is None else n_cols)
    pa = torch.arange(P, device=dev)
    rows = torch.arange(R, device=dev)
    cols = torch.arange(C, device=dev)
    col_in = cols < n_cols[:, None]                          # (P, C)
    u = cost.new_zeros((P, R))
    v = cost.new_zeros((P, C))
    col4row = torch.full((P, R), -1, dtype=torch.long, device=dev)
    row4col = torch.full((P, C), -1, dtype=torch.long, device=dev)
    steps = torch.zeros(P, dtype=torch.int32, device=dev)
    for cur in range(R):
        live = cur < n_rows                                  # (P,)
        if not live.any():
            break
        i = torch.full((P,), cur, dtype=torch.long, device=dev)
        min_val = cost.new_zeros(P)
        remaining = col_in.clone()
        shortest = torch.full((P, C), _INF, device=dev)
        path = torch.zeros((P, C), dtype=torch.long, device=dev)
        sr = torch.zeros((P, R), dtype=torch.bool, device=dev)
        sink = torch.full((P,), -1, dtype=torch.long, device=dev)
        going = live.clone()
        while going.any():                    # Dijkstra until a free column
            reduced = ((min_val[:, None] + cost[pa, i]) - u[pa, i][:, None]) - v
            lower = going[:, None] & remaining & (reduced < shortest)
            path = torch.where(lower, i[:, None], path)
            shortest = torch.where(lower, reduced, shortest)
            masked = torch.where(remaining, shortest, _INF)
            j = _argmin(masked)
            min_val = torch.where(going, masked[pa, j], min_val)
            sr[pa[going], i[going]] = True
            owner = row4col[pa, j]
            free = owner < 0
            sink = torch.where(going & free, j, sink)
            i = torch.where(going & ~free, owner, i)
            remaining[pa[going], j[going]] = False
            steps += going.int()
            going = going & ~free
        # the duals (scipy's update_dual_vectors), in JAX's order
        u[:, cur] = torch.where(live, u[:, cur] + min_val, u[:, cur])
        other = live[:, None] & sr & (rows != cur)
        assigned = shortest.gather(1, col4row.clamp(min=0))
        u = u + torch.where(other, min_val[:, None] - assigned, 0.0)
        visited = (live[:, None] & col_in & ~remaining
                   & (cols != sink[:, None]) & (shortest < _INF))
        v = v - torch.where(visited, min_val[:, None] - shortest, 0.0)
        j, going = sink, live.clone()         # augment along the path to sink
        while going.any():
            r = path[pa, j.clamp(min=0)]
            row4col[pa[going], j[going]] = r[going]
            prev = col4row[pa, r]
            col4row[pa[going], r[going]] = j[going]
            j = torch.where(going, prev, j)
            going = going & (r != cur)
    return (col4row, steps) if with_steps else col4row


linear_sum_assignment_ref.calls = 0


def _problems(cost, mask):
    """cost (..., R, C) and mask (..., R) (None: every row real) as (P, R,
    C) f32 and (P, R) bool, with the leading shape."""
    *lead, R, C = cost.shape
    cost = cost.reshape(-1, R, C).float()
    if mask is None:
        mask = torch.ones(cost.shape[:2], dtype=torch.bool,
                          device=cost.device)
    else:
        mask = torch.as_tensor(mask, device=cost.device).bool()
        mask = mask.expand(*lead, R).reshape(-1, R)
    return cost, mask, lead


def assignment_ref(cost, mask=None, with_steps=False):
    """Plain version of :func:`assignment` (the same rules, any device)."""
    cost, mask, lead = _problems(cost, mask)
    P, R, C = cost.shape
    if R <= C:
        safe = torch.nan_to_num(torch.where(mask[..., None], cost, 0.0),
                                nan=1e9, posinf=1e9, neginf=-1e9)
        out, steps = linear_sum_assignment_ref(safe, with_steps=True)
    else:
        out, steps = _more_rows_than_columns(cost, mask)
    out = out.reshape(*lead, R)
    return (out, steps.reshape(lead)) if with_steps else out


def _more_rows_than_columns(cost, mask):
    """The port's R > C rule, per problem (see the module's docstring)."""
    P, R, C = cost.shape
    dev = cost.device
    out = torch.full((P, R), -1, dtype=torch.long, device=dev)
    if C == 0:
        return out, torch.zeros(P, dtype=torch.int32, device=dev)
    n = mask.sum(1)
    slots = torch.sort((~mask).to(torch.uint8), dim=1, stable=True)[1]
    real = torch.nan_to_num(cost.gather(1, slots[..., None].expand(-1, -1, C)),
                            nan=1e9, posinf=1e9, neginf=-1e9)   # (P, R, C)
    flip = n > C
    work = real.new_zeros((P, R, R))
    work[:, :, :C] = real                      # the real rows, in slot order
    work = torch.where(flip[:, None, None],    # or the transposed problem
                       torch.cat([real.transpose(1, 2),
                                  real.new_zeros((P, R - C, R))], 1), work)
    col4row, steps = linear_sum_assignment_ref(
        work, n_rows=torch.where(flip, C, n), n_cols=torch.where(flip, n, C),
        with_steps=True)
    pa = torch.arange(P, device=dev)
    k = torch.arange(R, device=dev)
    # n <= C: the real slots' columns; the padded slots (after the real ones
    # in ``slots``) take the unused columns in ascending order, then -1
    used = torch.zeros((P, C + 1), dtype=torch.bool, device=dev)
    used[pa[:, None], torch.where((col4row >= 0) & ~flip[:, None], col4row,
                                  C)] = True
    unused = torch.sort(used[:, :C].to(torch.uint8), dim=1, stable=True)[1]
    m = k - n[:, None]                         # a padded slot's rank
    fill = unused.gather(1, m.clamp(0, C - 1))
    fill = torch.where(m < C - n[:, None], fill, -1)
    kept = torch.where(k < n[:, None], col4row, fill)
    out[pa[:, None], slots] = torch.where(flip[:, None], -1, kept)
    # n > C: column q's chosen real slot gets q
    q = torch.arange(C, device=dev)
    chosen = slots.gather(1, col4row[:, :C].clamp(min=0))
    out[pa[flip][:, None], chosen[flip]] = q
    return out, steps


@charges('assignment', lambda cost, *args, **kw: (0, nbytes(cost)))
def assignment(cost, mask=None, with_steps=False):
    """col4row (..., R) int64 of cost (..., R, C) under the row mask (...,
    R) (None: every row real), by the rules of the module's docstring.
    CPU tensors: the plain version.  CUDA tensors: the kernel, one launch
    for every problem, or an error.  ``with_steps``: also the Dijkstra
    steps each problem ran (..., ) int32.  Charges a counted run its cost
    matrix's bytes and no FLOPs (``utils/roofline.py``)."""
    if not cost.is_cuda:
        return assignment_ref(cost, mask, with_steps)
    if mask is not None and (not torch.is_tensor(mask)
                             or mask.device != cost.device):
        raise TypeError('the assignment kernel takes the mask as a tensor '
                        'on the costs\' device')
    if cost.dtype != torch.float32:
        raise TypeError(f'the assignment kernel takes float32 costs, not '
                        f'{cost.dtype}')
    cost, mask, lead = _problems(cost, mask)
    P, R, C = cost.shape
    cost, mask = cost.contiguous(), mask.contiguous()
    out = torch.empty((P, R), dtype=torch.long, device=cost.device)
    steps = (torch.zeros(P, dtype=torch.int32, device=cost.device)
             if with_steps else None)
    _cuda.check(_cuda.lib().cdll.dvc_assignment(
        cost.data_ptr(), mask.data_ptr(), P, R, C, out.data_ptr(),
        None if steps is None else steps.data_ptr(),
        _cuda.stream_ptr(cost.device)), 'dvc_assignment')
    _cuda.count_launch(assignment)
    out = out.reshape(*lead, R)
    return (out, steps.reshape(lead)) if with_steps else out


assignment.launches = 0


def masked_assignment(cost, row_mask):
    """JAX's ``masked_assignment``, batched over leading axes: cost (...,
    R, C), row_mask (..., R) -> col4row (..., R) int64 (R > C: the port's
    rule).  Arrays that are not tensors are taken as CPU tensors."""
    return assignment(torch.as_tensor(cost), torch.as_tensor(row_mask))


def many_to_one_assignment(cost, row_mask, rate: int = 4):
    """JAX's ``many_to_one_assignment``: up to ``rate`` columns a row, by
    the assignment of the cost tiled ``rate`` times along the rows (tiled
    row r is slot r % R).  cost (..., R, C), row_mask (..., R) -> col4row
    (..., rate, R) int64 (rate * R > C: the port's R > C rule on the tiled
    problem, where JAX refuses)."""
    cost, row_mask = torch.as_tensor(cost), torch.as_tensor(row_mask)
    R = cost.shape[-2]
    tiled = cost.repeat(*[1] * (cost.dim() - 2), rate, 1)
    tiled_mask = row_mask.repeat(*[1] * (row_mask.dim() - 1), rate)
    return masked_assignment(tiled, tiled_mask).unflatten(-1, (rate, R))
