"""Expanded-form constant-metric nearest neighbour, kernel E (port of
tools/exp_nn_hybrid_v5.py: ``nearest_const_exp``, ``nearest_const_hybrid``
and ``nearest_const_split3``).

The same argmin as kernel A (``nn_const``): for each candidate r_b, the
live row j < size minimising (x_j - r_b)' S (x_j - r_b) under one shared S,
with at most one wrapped angle dim a.  Here it is taken in expanded form.
The prep (``expand_prep``; the kernel builds the same in the launch)
shares A's ``whitening``, without A's permutation: L = cholesky(S + 1e-9 I),
centring on the candidate mean (dim a uncentred); then depth-8 features

    phi_j = [|z_j|^2, -2 z_j, 0...]    z = statesc @ L
    psi_b = [1, w_b, 0...]             w = xrandc @ L

and, for the wrap, x'_a = x_a / 2pi, r'_a = r_a / 2pi, P_j = -4pi
(statesc @ S[a])_j, Q_b = +4pi (xrandc @ S[a])_b and S_aa.  The kernel
computes

    c_bj = psi_b . phi_j + k (P_j + Q_b) + 4pi^2 S_aa k^2,
    k = rint(x'_a,j - r'_a,b),

and a running (c, j) minimum; the functions return ``(ids int32, c + |w_b|^2
f32)``.  The three differ only in how the depth-8 cross term is taken, the
kernel's ``mode``:

- ``"fma"``: fp32 products (``nn_exp``, ``nn_hybrid(prec="highest")``);
- ``"bf16"``: both operands rounded to bf16, products summed in fp32: one
  tensor-core pass (``nn_hybrid(prec="default")``);
- ``"bf16x3"``: the hi/lo split of both operands (``split_bf16``, lo then
  rounded to bf16) summed as hh + (hl + lh): three bf16 passes
  (``nn_split3``, ``nn_hybrid(prec="high")``).

Dead rows (j >= size) are masked by index and a non-finite cost never wins
(the JAX prep only poisons |z_j|^2, so a NaN row past ``size`` still poisons
its block there).  The lowest index wins ties.

Each wrapper takes its plain version for CPU tensors and the kernel
(``csrc/nn_expand.cu``) for CUDA tensors; there is no other path.  The
kernel's blocks merge on ``nn_kernel.pack_keys``' keys of c, as kernel A's
do, and the block that finishes last adds |w_b|^2: one launch a call.
``LAUNCHES`` counts the kernel's launches by mode, where they happen
(``launch_expand``): ``nn_hybrid`` spans all three modes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .nn_kernel import (_INV_TWO_PI, _PLAIN_BLOCK, _aligned, _blocked_argmin,
                        _check, _empty_result, _keyed_outputs, _launch, _mask,
                        _rint, whiten, whitening)

_TWO_PI = 2.0 * math.pi
DEPTH = 8                 # feature depth: |z|^2 and at most 7 coordinates
MAX_STATES = DEPTH - 1
MODES = ("fma", "bf16", "bf16x3")
_PREC_MODE = {"highest": "fma", "default": "bf16", "high": "bf16x3"}

LAUNCHES = dict.fromkeys(MODES, 0)


class ExpandPrep(NamedTuple):
    phi: torch.Tensor     # (N, 8) node features [|z|^2, -2 z, 0...]
    psi: torch.Tensor     # (B, 8) candidate features [1, w, 0...]
    nodew: torch.Tensor   # (N, 2) [x_a / 2pi, P] (zeros when unwrapped)
    candw: torch.Tensor   # (B, 2) [r_a / 2pi, Q] (zeros when unwrapped)
    saa: torch.Tensor     # (1,) S_aa (zero when unwrapped)
    w2: torch.Tensor      # (B,) |w|^2


def _norm2(z):
    """(R,) |z_j|^2 in fp64, rounded once to z's type, as the kernel's."""
    return (z.double() ** 2).sum(-1).to(z.dtype)


def expand_prep(states, S, xrand, wrap_dim: Optional[int]) -> ExpandPrep:
    """The features of the tool's shared prep (``exp_nn_hybrid_v5.py:
    85-133``), on the inputs' device, with no host sync."""
    N, n = states.shape
    B = xrand.shape[0]
    L, center, _ = whitening(S, xrand, wrap_dim, False)
    statesc = states - center
    xrandc = xrand - center
    z = whiten(statesc, L)
    w = whiten(xrandc, L)
    pad = DEPTH - 1 - n
    phi = torch.cat([_norm2(z)[:, None], -2.0 * z, z.new_zeros((N, pad))],
                    1)
    psi = torch.cat([w.new_ones((B, 1)), w, w.new_zeros((B, pad))], 1)
    if wrap_dim is None:
        nodew = states.new_zeros((N, 2))
        candw = xrand.new_zeros((B, 2))
        saa = L.new_zeros((1,))
    else:
        a = wrap_dim % n
        S0 = S[0] if S.dim() == 3 else S
        Sa = S0[a]
        nodew = torch.stack([states[:, a] * _INV_TWO_PI,
                             (-2.0 * _TWO_PI) * (statesc @ Sa)], 1)
        candw = torch.stack([xrand[:, a] * _INV_TWO_PI,
                             (2.0 * _TWO_PI) * (xrandc @ Sa)], 1)
        saa = S0[a, a].reshape(1)
    return ExpandPrep(phi, psi, nodew, candw, saa, _norm2(w))


def split_bf16(a):
    """(hi, lo) with hi = a rounded to nearest even on its top 16 bits (a
    bf16 value, as float32) and lo = a - hi: bit for bit the tool's
    ``split`` (``exp_nn_hybrid_v5.py:373-382``)."""
    ai = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (ai + 0x7FFF + ((ai >> 16) & 1)) & 0xFFFF0000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)   # as int32
    hi = bits.to(torch.int32).view(torch.float32).reshape(a.shape)
    return hi, a - hi


def _bf16(a):
    """a rounded to bf16 (nearest even), as float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _dot(psi, phi):
    """(B, R) depth-8 cross term psi . phi in fp32, summed in depth
    order."""
    c = psi[:, 0, None] * phi[None, :, 0]
    for d in range(1, DEPTH):
        c = c + psi[:, d, None] * phi[None, :, d]
    return c


def cross_term(psi, phi, mode: str):
    """The kernel's cross term for ``mode`` in plain PyTorch."""
    if mode == "fma":
        return _dot(psi, phi)
    if mode == "bf16":
        return _dot(_bf16(psi), _bf16(phi))
    if mode == "bf16x3":
        ph, pl = split_bf16(psi)
        fh, fl = split_bf16(phi)
        pl, fl = _bf16(pl), _bf16(fl)
        return _dot(ph, fh) + (_dot(ph, fl) + _dot(pl, fh))
    raise ValueError(f"unknown cross-term mode {mode!r}")


def error_scale(p: ExpandPrep, size):
    """(B,) M_b = (max_live |z_j| + |w_b|)^2, the bound on the summed
    terms' magnitude |z_j|^2 + 2 |z_j . w_b|.  The expanded cost cancels
    down to |z_j - w_b|^2, so each mode's error scales with M_b, not with
    the cost: see ``ERROR``."""
    live = torch.arange(p.phi.shape[0], device=p.phi.device) < size
    z2 = torch.where(live, p.phi[:, 0], 0.0).max()
    return (z2.sqrt() + p.w2.sqrt()) ** 2


# Per-pair error of each mode's cost, as a share of M_b (``error_scale``):
# fp32 products and sums of 8 terms, with the prep's own rounding, stay
# below 2^-20; bf16 rounds each operand by up to 2^-8, so a product by up
# to 2^-7 + 2^-16 (2^-6 with the fp32 sums); the three-pass split leaves
# 2^-16 of each operand (lo rounded to bf16) and drops lo * lo (2^-16), so
# 3 * 2^-16 (2^-14 with the sums).  A pick's excess over the true nearest
# is then at most twice its mode's error.
ERROR = {"fma": 2.0 ** -20, "bf16": 2.0 ** -6, "bf16x3": 2.0 ** -14}


def pick_cost64(p: ExpandPrep, ids, mode: str, wrapped: bool):
    """(B,) cost of each candidate's pick ``ids`` under ``mode``'s rounded
    operands, taken in fp64: the value the mode's arithmetic rounds.  Two
    picks whose values differ by the fp32 summation order only are
    equivalent."""
    psi, phi = p.psi, p.phi[ids.long()]
    if mode == "bf16":
        terms = [(_bf16(psi), _bf16(phi))]
    elif mode == "bf16x3":
        ph, pl = split_bf16(psi)
        fh, fl = split_bf16(phi)
        terms = [(ph, fh), (ph, _bf16(fl)), (_bf16(pl), fh)]
    else:
        terms = [(psi, phi)]
    c = sum((a.double() * b.double()).sum(-1) for a, b in terms)
    if wrapped:
        xp, P = p.nodew[ids.long()].unbind(-1)
        rp, Q = p.candw.unbind(-1)
        k = _rint(xp - rp).double()                  # as in fp32
        c = c + k * (P.double() + Q.double()) \
            + (_TWO_PI * _TWO_PI) * p.saa.double() * k * k
    return c + p.w2.double()


def expand_cost(p: ExpandPrep, j0: int, j1: int, mode: str, wrapped: bool):
    """(B, j1 - j0) costs c (without |w|^2) of every candidate against node
    rows j0..j1: the kernel's arithmetic in plain PyTorch."""
    c = cross_term(p.psi, p.phi[j0:j1], mode)
    if wrapped:
        xp, P = p.nodew[j0:j1, 0], p.nodew[j0:j1, 1]
        rp, Q = p.candw[:, 0], p.candw[:, 1]
        k = _rint(xp[None, :] - rp[:, None])
        c = c + k * (P[None, :] + Q[:, None]) \
            + ((_TWO_PI * _TWO_PI) * p.saa) * (k * k)
    return c


def nn_expand_plain(states, S, size, xrand, wrap_dim: Optional[int] = None,
                    mode: str = "fma", block: int = _PLAIN_BLOCK):
    """The plain version of every mode: a blocked fp32 scan of the
    expanded cost."""
    p = expand_prep(states, S, xrand, wrap_dim)

    def dist(j0, j1):
        return _mask(expand_cost(p, j0, j1, mode, wrap_dim is not None),
                     j0, j1, size)

    ids, best = _blocked_argmin(dist, states.shape[0], xrand.shape[0],
                                states.device, block)
    return ids, best + p.w2


def _prec_mode(prec: str) -> str:
    if prec not in _PREC_MODE:
        raise ValueError(f"prec must be one of {sorted(_PREC_MODE)}, "
                         f"got {prec!r}")
    return _PREC_MODE[prec]


def _check_expand(name, states, S, size, xrand):
    _check(name, states, S, size, xrand)
    if states.shape[1] > MAX_STATES:
        raise ValueError(f"{name}: the depth-{DEPTH} features hold n <= "
                         f"{MAX_STATES} states, got {states.shape[1]}")
    if not (states.is_contiguous() and xrand.is_contiguous()):
        raise ValueError(f"{name}: states and xrand must be contiguous")


def launch_expand(states, S, size, xrand, wrap_dim: Optional[int],
                  mode: str):
    """Launch ``lqrrt_nn_expand`` in ``mode`` on CUDA tensors; returns
    (ids, cost).  The launch builds the features, scans, merges its blocks
    on 64-bit keys and writes (ids, cost); the wrapper adds the candidate
    mean and the fill of the keys."""
    N, n = states.shape
    B = xrand.shape[0]
    if B == 0 or N == 0:
        return _empty_result(B, states.device)
    S0 = (S[0] if S.dim() == 3 else S).contiguous()
    keys, ids, cost = _keyed_outputs(B, states.device)
    _launch("lqrrt_nn_expand", _aligned(states), _aligned(xrand), S0,
            xrand.mean(0), size, keys, ids, cost, N, B, n, MODES.index(mode),
            -1 if wrap_dim is None else wrap_dim % n)
    LAUNCHES[mode] += 1
    return ids, cost


def _run(states, S, size, xrand, wrap_dim, mode):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if states.device.type == "cpu":
        return nn_expand_plain(states, S, size, xrand, wrap_dim, mode)
    return launch_expand(states, S, size, xrand, wrap_dim, mode)


def nn_exp(states, S, size, xrand, *, wrap_dim: Optional[int] = None):
    """``nearest_const_exp``: (ids, cost) with an fp32 cross term.  states
    (N, n), S (n, n) or (N, n, n) (row 0 used), size one int32 element on
    the same device, xrand (B, n), n <= 7."""
    _check_expand("nn_exp", states, S, size, xrand)
    return _run(states, S, size, xrand, wrap_dim, "fma")


def nn_hybrid(states, S, size, xrand, *, wrap_dim: Optional[int] = None,
              prec: str = "highest"):
    """``nearest_const_hybrid``: as ``nn_exp``, with the cross term at
    ``prec``: "highest" fp32, "high" three bf16 passes, "default" one."""
    _check_expand("nn_hybrid", states, S, size, xrand)
    return _run(states, S, size, xrand, wrap_dim, _prec_mode(prec))


def nn_split3(states, S, size, xrand, *, wrap_dim: Optional[int] = None):
    """``nearest_const_split3``: as ``nn_exp``, with the cross term as three
    bf16 passes over the hi/lo split."""
    _check_expand("nn_split3", states, S, size, xrand)
    return _run(states, S, size, xrand, wrap_dim, "bf16x3")
