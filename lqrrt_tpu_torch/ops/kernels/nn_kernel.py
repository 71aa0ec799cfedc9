"""LQR-metric nearest-neighbour kernels (port of lqrrt_tpu/ops/pallas/
nn_kernel.py): ``nn_const`` for one shared S (``nearest_const_pallas``,
kernel A) and ``nn_general`` for a per-node S (``nearest_pallas``, kernel C).

For each candidate r_b both return the argmin over live rows j < size of
(x_j - r_b)' S (x_j - r_b), with the wrap of at most one angle dim, the
lowest index winning ties and a non-finite cost never winning.  They return
``(ids int32, cost f32)`` with the true metric value, as the JAX kernels do.

``nn_const``: the state dims are permuted so that the wrapped dim a comes
first, ``L = cholesky(S_p + 1e-9 I)`` of the permuted S, and rows and
candidates are centred on the candidate mean (dim a uncentred) and
whitened, ``z = x_c L``, ``w = r_c L``.  L is lower triangular, so a turn
of dim a shifts z by ``(c0, 0, ..., 0)``, ``c0 = 2pi L[0, 0]``, and the
cost is ``|z_j - w_b - k (c0, 0, ...)|^2`` with ``k = rint(x_a / 2pi -
r_a / 2pi)`` (``nn_const_prep``, ``nn_const_dist``).  The kernel
(``csrc/nn_const.cu``) does all of it in the launch: it factors S, whitens
the candidates and each staged tile of rows, and unpacks its merge keys
into (ids, cost) in the block that finishes last.  The wrapper adds only
the candidate mean and the fill of the keys.

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
and ``nn_general.launches`` count kernel launches.  Both kernels' blocks
take slices of the live rows (``block_rows`` in csrc/nn_common.cuh) and
merge their first minima on ``pack_keys``' keys.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI
_ROUND = 12582912.0   # 1.5 * 2^23
_PLAIN_BLOCK = 1024   # node rows per step of the plain version's scan
_MAX_STATES = 16      # kMaxStates in csrc/nn_const.cu and nn_general.cu


def _rint(v):
    """v rounded to the nearest integer, ties to even, as two adds: ``(v +
    1.5 * 2^23) - 1.5 * 2^23`` in fp32 (kRound in csrc/nn_common.cuh), 1.5
    * 2^52 in fp64.  It equals ``torch.round(v)`` for |v| < 2^22 turns."""
    m = _ROUND if v.dtype == torch.float32 else 1.5 * 2.0 ** 52
    return (v + m) - m


def _perm(n: int, wrap_dim: Optional[int]):
    """The state dims with ``wrap_dim`` moved first (the identity without
    one); perm_dim in csrc/nn_common.cuh."""
    dims = list(range(n))
    if wrap_dim is not None:
        dims.insert(0, dims.pop(wrap_dim % n))
    return dims


def whitening(S, xrand, wrap_dim: Optional[int], wrap_first: bool):
    """(L, center, perm): ``L = cholesky(S_p + 1e-9 I)`` of S with its dims
    permuted as ``perm`` (the wrap dim first if ``wrap_first``), the jitter
    added in fp32, factored in fp64 and rounded to fp32; and the candidate
    mean with the wrap dim zeroed (angles stay uncentred).  S is (n, n) or
    (N, n, n) (row 0 used).  The constant-metric kernels do the same in the
    launch (``warp_cholesky``)."""
    n = xrand.shape[1]
    if S.dim() == 3:
        S = S[0]
    perm = _perm(n, wrap_dim if wrap_first else None)
    Sp = S[perm][:, perm]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    # cholesky_ex: no host-side error check, so no sync inside a chunk
    L = torch.linalg.cholesky_ex((Sp + 1e-9 * eye).double())[0].to(S.dtype)
    center = xrand.mean(0)
    if wrap_dim is not None:
        # a mask: writing a Python scalar into a device tensor would sync
        center = center * (torch.arange(n, device=S.device)
                           != wrap_dim % n)
    return L, center, perm


def whiten(xc, L, perm=None):
    """``xc[:, perm] @ L`` in fp64, rounded once to xc's type: the
    kernels' whitening of centred rows ``xc``."""
    if perm is not None:
        xc = xc[:, perm]
    return (xc.double() @ L.double()).to(xc.dtype)


def nn_const_prep(states, S, xrand, wrap_dim: Optional[int]):
    """(z, w, xp, rp, c0): whitened centred nodes and candidates in the
    permuted dims (the wrap dim first), the wrap dim's raw values over 2pi,
    and the whitened shift of one turn along z_0 (zeros without a wrap)."""
    L, center, perm = whitening(S, xrand, wrap_dim, True)
    z = whiten(states - center, L, perm)
    w = whiten(xrand - center, L, perm)
    if wrap_dim is None:
        xp = states.new_zeros(states.shape[0])
        rp = xrand.new_zeros(xrand.shape[0])
        c0 = L.new_zeros(())
    else:
        a = wrap_dim % states.shape[1]
        xp = states[:, a] * _INV_TWO_PI
        rp = xrand[:, a] * _INV_TWO_PI
        c0 = _TWO_PI * L[0, 0]
    return z, w, xp, rp, c0


def nn_const_dist(z, w, xp, rp, c0, wrapped: bool):
    """(B, R) costs of candidates w against node rows z: the kernel's
    arithmetic in plain PyTorch, fp32, elementwise."""
    d = z[None, :, :] - w[:, None, :]
    if wrapped:
        k = _rint(xp[None, :] - rp[:, None])
        d = torch.cat([(d[..., 0] - k * c0)[..., None], d[..., 1:]], -1)
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
    z, w, xp, rp, c0 = nn_const_prep(states, S, xrand, wrap_dim)

    def dist(j0, j1):
        cost = nn_const_dist(z[j0:j1], w, xp[j0:j1], rp, c0,
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
# to the lowest index.  pack_key in csrc/nn_common.cuh makes the same bits.
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
    if S.shape[-2:] != (states.shape[1],) * 2 or S.dim() not in (2, 3):
        raise ValueError(f"{name}: S must be (n, n) or (N, n, n) with n = "
                         f"{states.shape[1]}, got {tuple(S.shape)}")
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


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA device (the kernels' launch geometry)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t):
    """``t`` if it is contiguous and 16-byte aligned (the kernels' bulk
    copies need both), else such a copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _keyed_outputs(B: int, device):
    """(keys, ids, cost): the merge keys, filled with EMPTY_KEY, with one
    slot more, the counter of finished blocks (``last_block`` in
    csrc/nn_common.cuh), and the outputs that the launch writes."""
    return (torch.full((B + 1,), EMPTY_KEY, dtype=torch.int64, device=device),
            torch.empty((B,), dtype=torch.int32, device=device),
            torch.empty((B,), dtype=torch.float32, device=device))


def _empty_result(B: int, device):
    return (torch.zeros((B,), dtype=torch.int32, device=device),
            torch.full((B,), math.inf, device=device))


def nn_const(states, S, size, xrand, wrap_dim: Optional[int] = None):
    """(ids, cost) of each candidate's nearest live node under one shared
    S.  states (N, n), S (n, n) or (N, n, n) (row 0 used), size 0-d int32
    on the same device, xrand (B, n)."""
    _check("nn_const", states, S, size, xrand)
    if states.device.type == "cpu":
        return nn_const_plain(states, S, size, xrand, wrap_dim)
    N, n = states.shape
    B = xrand.shape[0]
    if B == 0 or N == 0:
        return _empty_result(B, states.device)
    S0 = (S[0] if S.dim() == 3 else S).contiguous()
    keys, ids, cost = _keyed_outputs(B, states.device)
    _launch("lqrrt_nn_const", _aligned(states), _aligned(xrand), S0,
            xrand.mean(0), size, keys, ids, cost, N, B, n,
            -1 if wrap_dim is None else wrap_dim % n)
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
        return _empty_result(B, states.device)
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
