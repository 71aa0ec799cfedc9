"""Constant-metric LQR nearest neighbour (port of lqrrt_tpu/ops/pallas/
nn_kernel.py ``nearest_const_pallas``).

For each candidate r_b: the argmin over live rows j < size of
(x_j - r_b)' S (x_j - r_b) for ONE shared S (the tree's S[0]), with the
closed-form wrap of one angle dim, lowest index winning ties.  Returns
``(ids int32, cost f32)`` with the true metric value, as the JAX kernel does.

The prep stays in PyTorch, as JAX keeps it outside the ``pallas_call``:
``L = cholesky(S + 1e-9 I)``, centring on the candidate mean (the wrap dim
left uncentred), ``z = statesc @ L`` and ``w = xrandc @ L``.  The distance
and the argmin are the kernel (``csrc/nn_const.cu``, whose header says what
bounds it on the H100 and what its design does about that):
``cost = |z_j - w_b - k c|^2`` with ``k = rint((x_a - r_a) / 2pi)`` and
``c = 2pi L[a, :]``.

``nn_const`` takes the plain PyTorch version for CPU tensors and the kernel
for CUDA tensors; there is no other path.  ``nn_const.launches`` counts
kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_TWO_PI = 2.0 * math.pi
_PLAIN_BLOCK = 1024   # node rows per step of the plain version's scan
_MAX_STATES = 16      # kMaxStates in csrc/nn_const.cu


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


def nn_const_plain(states, S, size, xrand, wrap_dim: Optional[int] = None,
                   block: int = _PLAIN_BLOCK):
    """The plain version: a blocked scan with a running (min, argmin);
    strict '<' across blocks and the first minimum inside one, so the
    lowest index wins ties."""
    N = states.shape[0]
    B = xrand.shape[0]
    z, w, xa, ra, c = nn_const_prep(states, S, xrand, wrap_dim)
    best = torch.full((B,), math.inf, dtype=torch.float32,
                      device=states.device)
    best_id = torch.zeros((B,), dtype=torch.int32, device=states.device)
    for j0 in range(0, N, block):
        j1 = min(j0 + block, N)
        cost = nn_const_dist(z[j0:j1], w, xa[j0:j1], ra, c,
                             wrap_dim is not None)
        idx = torch.arange(j0, j1, device=states.device)
        cost = torch.where(idx[None, :] < size, cost, math.inf)
        bc, bi = cost.min(dim=1)
        take = bc < best
        best = torch.where(take, bc, best)
        best_id = torch.where(take, (bi + j0).to(torch.int32), best_id)
    return best_id, best


def _check(states, S, size, xrand):
    for name, t in (("states", states), ("S", S), ("xrand", xrand)):
        if t.dtype != torch.float32:
            raise TypeError(f"nn_const: {name} must be float32")
        if t.device != states.device:
            raise ValueError("nn_const: all inputs must share a device")
    if states.dim() != 2 or xrand.dim() != 2 or xrand.shape[1] != \
            states.shape[1]:
        raise ValueError(f"nn_const: states (N, n) and xrand (B, n), got "
                         f"{tuple(states.shape)} and {tuple(xrand.shape)}")
    if size.dtype != torch.int32 or size.numel() != 1 or \
            size.device != states.device:
        raise TypeError("nn_const: size must be one int32 element on the "
                        "inputs' device")


def nn_const(states, S, size, xrand, wrap_dim: Optional[int] = None):
    """(ids, cost) of each candidate's nearest live node under one shared
    S.  states (N, n), S (n, n) or (N, n, n) (row 0 used), size 0-d int32
    on the same device, xrand (B, n)."""
    _check(states, S, size, xrand)
    if states.device.type == "cpu":
        return nn_const_plain(states, S, size, xrand, wrap_dim)
    if states.device.type != "cuda":
        raise ValueError(f"nn_const: unsupported device {states.device}")
    from . import _build

    N, n = states.shape
    B = xrand.shape[0]
    if n > _MAX_STATES:
        raise ValueError(f"nn_const: the kernel takes n <= {_MAX_STATES} "
                         f"states, got {n}")
    z, w, xa, ra, c = nn_const_prep(states, S, xrand, wrap_dim)
    ids = torch.empty((B,), dtype=torch.int32, device=states.device)
    cost = torch.empty((B,), dtype=torch.float32, device=states.device)
    if B == 0:
        return ids, cost
    stream = torch.cuda.current_stream(states.device).cuda_stream
    with torch.cuda.device(states.device):
        err = _build.lib().lqrrt_nn_const(
            z.data_ptr(), xa.data_ptr(), w.data_ptr(), ra.data_ptr(),
            c.data_ptr(), size.data_ptr(), ids.data_ptr(), cost.data_ptr(),
            N, B, n, int(wrap_dim is not None), stream)
    _build.check(err, "nn_const")
    nn_const.launches += 1
    return ids, cost


nn_const.launches = 0


def make_nearest_const(wrap_dim: Optional[int] = None):
    """Adapter with core.nearest.make_nearest's signature."""
    def nearest(states, S, size, xrand):
        return nn_const(states, S, size, xrand, wrap_dim=wrap_dim)
    return nearest
