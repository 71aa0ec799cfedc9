"""Seven scaffold probes (port of tools/dbg_steer_scaffold.py: ``attempt``
and the kernels it runs, :30-100).

The tool asked which piece of the rollout kernel's structure Mosaic would
lower, on (6, B) f32 inputs with H = 100.  Each probe here is a small CUDA
kernel (``csrc/scaffold_probes.cu``, one entry point
``lqrrt_scaffold_probe``) beside its plain PyTorch version, which is the
library call itself.  ``probe(name, *args)`` takes the tool's arguments:

- "A" 2d-copy: (x,) -> 2 x;
- "B" 3d-static-write: (x,) -> x broadcast to (H, 6, B);
- "C" fori-ds-store: (x,) -> c_h = 1.01 c_{h-1}, c_0 = x, for h = 1..H;
- "D" 1d-output: (x,) -> the column sum (B,);
- "E" bool-carry-1d-int-out: (x,) -> whether a column sum of c passed
  1e9 in H steps of c = 1.01 c, as int32 (B,);
- "F" 1d-input: (g (6,), x) -> x + g[:, None];
- "G" 2d-const-input: (c2 (7, 2), x) -> x + the sum of c2.

CPU tensors take the plain version, CUDA tensors the kernel; there is no
other path.  ``LAUNCHES`` counts the kernel's launches by probe.
``probe_geometry`` picks each launch's grid: B and C, which write
(H, 6, B), spread over the card by B and its SM count; the others one
thread a column, ``BLOCK`` a block.
"""
from __future__ import annotations

import functools
import itertools

import torch

from .nn_kernel import _launch, sm_count

H, NS, BLOCK = 100, 6, 256
NAMES = {"A": "A 2d-copy", "B": "B 3d-static-write", "C": "C fori-ds-store",
         "D": "D 1d-output", "E": "E bool-carry-1d-int-out",
         "F": "F 1d-input", "G": "G 2d-const-input"}
PROBES = tuple(NAMES)
LAUNCHES = dict.fromkeys(PROBES, 0)


def _loop_c(x):
    return torch.stack(list(itertools.accumulate(
        range(H), lambda c, _: c * 1.01, initial=x))[1:])


def _loop_e(x):
    return functools.reduce(
        lambda cd, _: (cd[0] * 1.01, cd[1] | (cd[0].sum(0) > 1e9)), range(H),
        (x, torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device))
    )[1].int()


PLAIN = {
    "A": lambda x: x * 2.0,
    "B": lambda x: x.expand(H, *x.shape).contiguous(),
    "C": _loop_c,
    "D": lambda x: x.sum(0),
    "E": _loop_e,
    "F": lambda g, x: x + g[:, None],
    "G": lambda c2, x: x + c2.sum(),
}
_AUX = {"F": (NS,), "G": (7, 2)}


def probe_geometry(name: str, B: int, sms: int, aligned: bool = True):
    """(threads, blocks_x, blocks_y, h_per, vec) of probe ``name``'s
    launch on (6, B) inputs, on a card of ``sms`` SMs.

    - B: thread e of grid row y stores x's element e (vec floats: 4 where
      6B is a multiple of 4 and ``aligned``, else 1) at steps
      [y h_per, (y + 1) h_per) of H; about 4 blocks an SM;
    - C: thread e runs the chain of x's element e over all H steps, 256
      threads a block or fewer (a multiple of 32) where that leaves an SM
      without a block;
    - the others: thread b takes column b, ``BLOCK`` a block."""
    def cdiv(a, b):
        return -(-a // b)

    n = NS * B
    if name == "B":
        vec = 4 if aligned and n % 4 == 0 else 1
        threads = BLOCK
        bx = cdiv(n // vec, threads)
        h_per = cdiv(H, min(H, max(1, cdiv(4 * sms, max(bx, 1)))))
        return threads, bx, cdiv(H, h_per), h_per, vec
    if name == "C":
        threads = max(32, min(BLOCK, n // max(sms, 1) // 32 * 32))
        return threads, cdiv(n, threads), 1, H, 1
    return BLOCK, cdiv(B, BLOCK), 1, H, 1


def plain(name: str, *args):
    """The probe's plain PyTorch version, on any device."""
    return PLAIN[name](*args)


def probe(name: str, *args):
    """The probe ``name`` on the tool's arguments: the plain version for
    CPU tensors, the kernel for CUDA tensors (``probe_geometry``)."""
    if name not in PLAIN:
        raise ValueError(f"probe: unknown probe {name!r}; one of {PROBES}")
    aux, x = (args if name in _AUX else (None, *args))
    for t in (x,) if aux is None else (aux, x):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"probe {name}: inputs must be contiguous "
                            "float32")
        if t.device != x.device or x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"probe {name}: inputs must share a CPU or "
                             "CUDA device")
    if x.dim() != 2 or x.shape[0] != NS or (
            aux is not None and tuple(aux.shape) != _AUX[name]):
        raise ValueError(f"probe {name}: x must be ({NS}, B)"
                         + (f" and its constant {_AUX[name]}" if aux
                            is not None else "")
                         + f", got {[tuple(a.shape) for a in args]}")
    if x.device.type == "cpu":
        return plain(name, *args)
    B = x.shape[1]
    shape = {"B": (H, NS, B), "C": (H, NS, B), "D": (B,), "E": (B,)}.get(
        name, (NS, B))
    y = torch.empty(shape, dtype=torch.int32 if name == "E" else torch.float32,
                    device=x.device)
    if B:
        aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
        _launch("lqrrt_scaffold_probe", x, aux, y, PROBES.index(name), B, H,
                *probe_geometry(name, B, sm_count(x.device), aligned))
        LAUNCHES[name] += 1
    return y
