"""LQR-metric nearest-neighbour kernels (port of lqrrt_tpu/ops/pallas/
nn_kernel.py): ``nn_const`` for one shared S (``nearest_const_pallas``,
kernel A) and ``nn_general`` for a per-node S (``nearest_pallas``, kernel C).

For each candidate r_b both return the argmin over live rows j < size of
(x_j - r_b)' S (x_j - r_b), with the wrap of at most one angle dim, the
lowest index winning ties and a non-finite cost never winning.  They return
``(ids int32, cost f32)`` with the true metric value, as the JAX kernels do.

``nn_const``: the prep stays in PyTorch, as JAX keeps it outside the
``pallas_call``: ``L = cholesky(S + 1e-9 I)``, centring on the candidate mean
(the wrap dim left uncentred), ``z = statesc @ L`` and ``w = xrandc @ L``.
The distance and the argmin are the kernel (``csrc/nn_const.cu``):
``cost = |z_j - w_b - k c|^2`` with ``k = rint((x_a - r_a) / 2pi)`` and
``c = 2pi L[a, :]``.

``nn_general``: the prep folds each S_j into the upper triangle U_j of its
symmetric part (``nn_general_fold``: U_ii = S_ii, U_ik = S_ik + S_ki for
i < k) and packs it with x_j into one row a node, the wrapped dim moved
first; the kernel (``csrc/nn_general.cu``) evaluates e' S_j e =
sum_i e_i sum_{k >= i} U_ik e_k with e = x_j - r_b and e_a -= 2pi
rint(e_a / 2pi).  Its blocks merge their partial argmins with one 64-bit
``atomicMin`` a candidate on ``pack_keys``' keys, which ``unpack_keys``
turns back into (ids, cost).

Each wrapper takes its plain PyTorch version for CPU tensors and its kernel
for CUDA tensors; there is no other path.  Each header says what bounds the
kernel on the H100 and what its design does about it.  ``nn_const.launches``
and ``nn_general.launches`` count kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_TWO_PI = 2.0 * math.pi
_PLAIN_BLOCK = 1024   # node rows per step of the plain version's scan
_MAX_STATES = 16      # kMaxStates in csrc/nn_const.cu and nn_general.cu


def nn_const_prep(states, S, xrand, wrap_dim: Optional[int]):
    """(z, w, x_a, r_a, c): whitened centred nodes and candidates, the wrap
    dim's raw values, and the whitened shift of one turn."""
    n = states.shape[1]
    if S.dim() == 3:
        S = S[0]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    # cholesky_ex: no host-side error check, so no sync inside a chunk
    L, _ = torch.linalg.cholesky_ex(S + 1e-9 * eye)
    center = xrand.mean(0)
    if wrap_dim is not None:
        # angles stay wrapped; a mask, since writing a Python scalar into
        # a device tensor would copy it from the host and sync
        center = center * (torch.arange(n, device=S.device) != wrap_dim)
    statesc = states - center
    xrandc = xrand - center
    z = (statesc @ L).contiguous()
    w = (xrandc @ L).contiguous()
    if wrap_dim is None:
        xa = torch.zeros_like(states[:, 0])
        ra = torch.zeros_like(xrand[:, 0])
        c = torch.zeros_like(L[0])
    else:
        xa = states[:, wrap_dim].contiguous()
        ra = xrand[:, wrap_dim].contiguous()
        c = (_TWO_PI * L[wrap_dim]).contiguous()
    return z, w, xa, ra, c


def nn_const_dist(z, w, xa, ra, c, wrapped: bool):
    """(B, R) costs of candidates w against node rows z: the kernel's
    arithmetic in plain PyTorch, fp32, elementwise."""
    d = z[None, :, :] - w[:, None, :]
    if wrapped:
        k = torch.round((xa[None, :] - ra[:, None]) * (1.0 / _TWO_PI))
        d = d - k[:, :, None] * c
    return (d * d).sum(-1)


def _mask(cost, j0: int, j1: int, size):
    """Dead rows (j >= size) and non-finite costs become +inf, so neither
    can win."""
    idx = torch.arange(j0, j1, device=cost.device)
    return torch.where(torch.isfinite(cost) & (idx[None, :] < size), cost,
                       math.inf)


def _blocked_argmin(dist, N: int, B: int, device, block: int):
    """Running (min, argmin) over row blocks; ``dist(j0, j1)`` gives the
    (B, j1 - j0) costs.  Strict '<' across blocks and the first minimum
    inside one, so the lowest index wins ties."""
    best = torch.full((B,), math.inf, dtype=torch.float32, device=device)
    best_id = torch.zeros((B,), dtype=torch.int32, device=device)
    for j0 in range(0, N, block):
        j1 = min(j0 + block, N)
        bc, bi = dist(j0, j1).min(dim=1)
        take = bc < best
        best = torch.where(take, bc, best)
        best_id = torch.where(take, (bi + j0).to(torch.int32), best_id)
    return best_id, best


def nn_const_plain(states, S, size, xrand, wrap_dim: Optional[int] = None,
                   block: int = _PLAIN_BLOCK):
    """The plain version of ``nn_const``: a blocked scan of the whitened
    distance."""
    z, w, xa, ra, c = nn_const_prep(states, S, xrand, wrap_dim)

    def dist(j0, j1):
        cost = nn_const_dist(z[j0:j1], w, xa[j0:j1], ra, c,
                             wrap_dim is not None)
        return _mask(cost, j0, j1, size)

    return _blocked_argmin(dist, states.shape[0], xrand.shape[0],
                           states.device, block)


def nn_general_dist(states, S, xrand, wrap_dim: Optional[int]):
    """(B, R) costs e' S_j e of candidates xrand (B, n) against node rows
    states (R, n) with per-node S (R, n, n): the kernel's arithmetic in
    plain PyTorch, fp32.  e = x_j - r_b, and the wrap dim a is shifted by
    -2pi rint(e_a / 2pi)."""
    e = states[None, :, :] - xrand[:, None, :]              # (B, R, n)
    if wrap_dim is not None:
        a = e[..., wrap_dim]
        a -= torch.round(a * (1.0 / _TWO_PI)) * _TWO_PI     # in place in e
    q = torch.einsum("rik,brk->bri", S, e)                  # S_j e
    return (e * q).sum(-1)


_FOLD_INDEX = {}


def _fold_index(n: int, wrap_dim: Optional[int], device):
    """(ia, ib, perm): for each column f of a packed row, the two columns
    of [states | S flattened | 0] whose sum it is (the zero column z for a
    term that is not there), and the permutation of the state dims.  Made
    on ``device`` from device ops (no copy from the host) and memoised."""
    key = (n, wrap_dim, str(device))
    if key not in _FOLD_INDEX:
        perm = torch.arange(n, device=device)
        if wrap_dim is not None:
            a = wrap_dim % n
            perm = torch.cat([perm[a:a + 1], perm[:a], perm[a + 1:]])
        i, k = torch.triu_indices(n, n, device=device)
        pi, pk = perm.index_select(0, i), perm.index_select(0, k)
        z = n + n * n
        pad = torch.full((-(n + i.numel()) % 4,), z, device=device)
        ia = torch.cat([perm, n + pi * n + pk, pad])
        ib = torch.cat([torch.full((n,), z, device=device),
                        torch.where(i == k, z, n + pk * n + pi), pad])
        _FOLD_INDEX[key] = (ia, ib, perm)
    return _FOLD_INDEX[key]


def nn_general_fold(states, S, wrap_dim: Optional[int]):
    """(rows, perm): the kernel's packed node rows and the permutation of
    the state dims that puts ``wrap_dim`` first.  Row j is [x_j[perm],
    U_j, zeros to a multiple of 4], with U_j the row-major upper triangle
    of S_j's symmetric part in the permuted dims: U_ii = S_ii and U_ik =
    S_ik + S_ki for i < k.  Exact algebra for any S: e' S e = sum_i e_i
    sum_{k >= i} U_ik e_k; only the rounding of S_ik + S_ki differs.  Two
    gathers and one add over [states | S | 0]."""
    N, n = states.shape
    ia, ib, perm = _fold_index(n, wrap_dim, states.device)
    src = torch.cat([states, S.reshape(N, n * n), states.new_zeros((N, 1))],
                    1)
    return src.index_select(1, ia) + src.index_select(1, ib), perm


def nn_general_fold_dist(rows, xr, n: int, wrapped: bool):
    """(B, R) costs of candidates xr (B, n, permuted as ``perm``) against
    packed rows (R, .) from ``nn_general_fold``: the kernel's arithmetic
    in plain PyTorch.  ``wrapped``: the first dim is the wrapped one."""
    e = rows[None, :, :n] - xr[:, None, :]                  # (B, R, n)
    if wrapped:
        a = e[..., 0]
        a -= torch.round(a * (1.0 / _TWO_PI)) * _TWO_PI     # in place in e
    i, k = torch.triu_indices(n, n, device=rows.device)
    U = rows.new_zeros((rows.shape[0], n, n))
    U[:, i, k] = rows[:, n:n + i.numel()]
    t = torch.einsum("rik,brk->bri", U, e)                  # sum_{k>=i}
    return (e * t).sum(-1)


# The merge key of (cost, id): the order-preserving int32 of cost + 0.0
# (so -0.0 and +0.0 tie) in the high half and the row in the low half, so
# that int64 order is (cost, id) order: the lowest cost wins and a tie goes
# to the lowest index.  csrc/nn_general.cu's pack_key makes the same bits.
def pack_keys(cost, ids):
    """int64 merge keys of float32 ``cost`` and int ``ids`` (>= 0)."""
    bits = (cost.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return order * (1 << 32) + ids.to(torch.int64)


EMPTY_KEY = 0x7F800000 << 32   # pack_keys(+inf, 0): no live row yet


def unpack_keys(keys):
    """(ids int32, cost float32) of int64 merge keys; exact inverse of
    ``pack_keys`` (up to -0.0, which packs as +0.0)."""
    ids = (keys & 0xFFFFFFFF).to(torch.int32)
    order = keys >> 32
    bits = order ^ ((order >> 31) & 0x7FFFFFFF)
    return ids, bits.to(torch.int32).view(torch.float32)


def nn_general_plain(states, S, size, xrand, wrap_dim: Optional[int] = None,
                     block: int = _PLAIN_BLOCK):
    """The plain version of ``nn_general``: a blocked scan of e' S_j e."""
    def dist(j0, j1):
        cost = nn_general_dist(states[j0:j1], S[j0:j1], xrand, wrap_dim)
        return _mask(cost, j0, j1, size)

    return _blocked_argmin(dist, states.shape[0], xrand.shape[0],
                           states.device, block)


def _check(name, states, S, size, xrand):
    for what, t in (("states", states), ("S", S), ("xrand", xrand)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32")
        if t.device != states.device:
            raise ValueError(f"{name}: all inputs must share a device")
    if states.dim() != 2 or xrand.dim() != 2 or xrand.shape[1] != \
            states.shape[1]:
        raise ValueError(f"{name}: states (N, n) and xrand (B, n), got "
                         f"{tuple(states.shape)} and {tuple(xrand.shape)}")
    if size.dtype != torch.int32 or size.numel() != 1 or \
            size.device != states.device:
        raise TypeError(f"{name}: size must be one int32 element on the "
                        "inputs' device")
    if states.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {states.device}")
    if states.device.type == "cuda" and states.shape[1] > _MAX_STATES:
        raise ValueError(f"{name}: the kernel takes n <= {_MAX_STATES} "
                         f"states, got {states.shape[1]}")


def _launch(fn, *args):
    """Call the C entry point ``fn`` on the current stream of the first
    tensor's device and raise if the launch failed."""
    from . import _build

    dev = args[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), fn)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream)
    _build.check(err, fn)


def nn_const(states, S, size, xrand, wrap_dim: Optional[int] = None):
    """(ids, cost) of each candidate's nearest live node under one shared
    S.  states (N, n), S (n, n) or (N, n, n) (row 0 used), size 0-d int32
    on the same device, xrand (B, n)."""
    _check("nn_const", states, S, size, xrand)
    if states.device.type == "cpu":
        return nn_const_plain(states, S, size, xrand, wrap_dim)
    N, n = states.shape
    B = xrand.shape[0]
    z, w, xa, ra, c = nn_const_prep(states, S, xrand, wrap_dim)
    ids = torch.empty((B,), dtype=torch.int32, device=states.device)
    cost = torch.empty((B,), dtype=torch.float32, device=states.device)
    if B == 0:
        return ids, cost
    _launch("lqrrt_nn_const", z, xa, w, ra, c, size, ids, cost, N, B, n,
            int(wrap_dim is not None))
    nn_const.launches += 1
    return ids, cost


nn_const.launches = 0


def nn_general(states, S, size, xrand, wrap_dim: Optional[int] = None):
    """(ids, cost) of each candidate's nearest live node under its per-node
    S.  states (N, n), S (N, n, n), size 0-d int32 on the same device,
    xrand (B, n)."""
    _check("nn_general", states, S, size, xrand)
    N, n = states.shape
    if S.shape != (N, n, n):
        raise ValueError(f"nn_general: S must be (N, n, n) = {(N, n, n)}, "
                         f"got {tuple(S.shape)}")
    if states.device.type == "cpu":
        return nn_general_plain(states, S, size, xrand, wrap_dim)
    B = xrand.shape[0]
    if B == 0 or N == 0:
        return (torch.zeros((B,), dtype=torch.int32, device=states.device),
                torch.full((B,), math.inf, device=states.device))
    rows, perm = nn_general_fold(states, S, wrap_dim)
    xr = xrand.index_select(1, perm).contiguous()
    keys = torch.full((B,), EMPTY_KEY, dtype=torch.int64,
                      device=states.device)
    _launch("lqrrt_nn_general", rows, xr, size, keys, N, B, n,
            int(wrap_dim is not None))
    nn_general.launches += 1
    return unpack_keys(keys)


nn_general.launches = 0


def make_nearest_const(wrap_dim: Optional[int] = None):
    """Adapter with core.nearest.make_nearest's signature."""
    def nearest(states, S, size, xrand):
        return nn_const(states, S, size, xrand, wrap_dim=wrap_dim)
    return nearest


def make_nearest_general(wrap_dim: Optional[int] = None):
    """Adapter with core.nearest.make_nearest's signature."""
    def nearest(states, S, size, xrand):
        return nn_general(states, S, size, xrand, wrap_dim=wrap_dim)
    return nearest
