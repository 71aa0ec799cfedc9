"""Kernels A, B, C and E alone on the card, at the planner's shapes.

    python -m lqrrt_tpu_torch.tools.kernel_times [--reps 20]
        [--only A,B,C,E] [--wrappers-only | --launches-only]

B, the block-column write (``block_write``), on an edge buffer dst
(100, C, 40960) with src (100, C, 8192) at start 8704, for C = 6 and 3,
beside the one PyTorch call that computes the same write,
``dst[..., 8704:8704 + 8192].copy_(src)``.  Both are timed alone
(``exp_steer_kernel.device_ms``: the stream spins while the host enqueues
the call) in turns, kernel, copy_, copy_, kernel, in three conditions: L2
cold (a 64 MB buffer is written before each spin, outside the timed
events, so the call also writes back the dirty lines it evicts), L2 cold
and clean (the same write, then a read of another 64 MB buffer) and L2
warm (src and the dst slice, 2 x 19.7 MB at C = 6, stay in the 50 MB L2
from the call before).

C, the per-node-S nearest neighbour (``nn_general``), at N = 40960 rows
with size 32768 live, B = 8192 candidates, n = 4 (wrap dim 2) and n = 12
(wrap dim 5), random SPD per-node S: the wrapper alone (``device_ms``, its
prep included) and with its host dispatch (CUDA events around one call).

A, the constant-metric nearest neighbour (``nn_const``), at N = 40960,
size 32768, B = 8192: n = 6 on the boat's data and S (wrap dim 2, as
``exp_nn_hybrid.problem`` makes them), and n = 4 (wrap dim 2) and n = 12
(wrap dim 5) with uniform data and a random SPD S.  E, the expanded-form
variants (``nn_hybrid``'s three modes), on the boat's inputs, wrapped and
not.  For each, the wrapper alone and with its dispatch, the launch alone
(``const_launcher``, ``expand_launcher``: the keys refilled before each
spin, outside the timed events) and the prep alone (the candidate mean and
the fill of the keys), each time beside its share of the bound
(``const_bound``, ``expand_bound``).  ``--wrappers-only`` times only what
the wrappers' public calls offer, and ``--launches-only`` only the
launches, so that both also run on an older tree of the package (E's
launch there is its two kernels on features prepared once; see
``expand_launcher``).  Then A's and E's registers, shared memory and
spills, as ``ptxas -v`` gave them when the library was built.

Every line names the card (``nvidia-smi`` name and power limit).  The
device is the card: there is no CPU path.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess

import torch

from ..ops.kernels import nn_hybrid
from ..ops.kernels.nn_kernel import nn_const, nn_general
from ..ops.kernels.write_kernel import block_write
from .exp_nn_hybrid import problem
from .exp_steer_kernel import device_ms, timed_ms

N, B = 40960, 8192
B_START = 512 + 8192     # the second batch's column block, as the planner's
SIZE = 32768
FLUSH_BYTES = 64 << 20   # larger than the H100's 50 MB L2
# H100 SXM peaks (NVIDIA's data sheet, dense): flop/s by type, HBM bytes/s
PEAKS = {"fp32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
PARTS = ("wrapper", "launch", "prep")


def bound(flops=None, nbytes=0.0):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and each type's operations over its peak (PEAKS)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max([f / PEAKS[k] * 1e3 for k, f in (flops or {}).items()],
                default=0.0)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def const_flops(n: int, wrapped: bool) -> dict:
    """Flops by type a (candidate, row) pair of kernel A's function: n subs
    z_i - w_i and the squares summed (a mul and n - 1 FMAs); wrapped, the
    turn k = rint(x'_a - r'_a) (a sub, a rint) and the FMA that moves z_0
    by k c0 (the wrap dim permuted first, a turn moves z_0 only)."""
    return {"fp32": 3 * n - 1 + (4 if wrapped else 0)}


def expand_flops(mode: str, n: int, wrapped: bool) -> dict:
    """Flops by type a pair of kernel E's function: the cross term, n
    multiply-adds onto |z_j|^2 (psi's leading 1 and the zero pad are
    layout, not work), in fp32, or in bf16 a pass (three passes and one
    fp32 add in bf16x3); wrapped, the epilogue (sub, mul, rint, add, fma,
    mul, fma: 9 flops)."""
    epi = 9 if wrapped else 0
    return {"fma": {"fp32": epi + 2 * n},
            "bf16": {"fp32": epi, "bf16": 2 * n},
            "bf16x3": {"fp32": epi + 1, "bf16": 3 * 2 * n}}[mode]


def nn_bound(flops_a_pair: dict, n: int, size: int = SIZE, b: int = B):
    """(ms, what bounds it) of one constant-S argmin over ``size`` live rows
    for ``b`` candidates: the pairs' flops, and the raw rows and
    candidates read once plus the (ids, cost) written once."""
    return bound({k: size * b * f for k, f in flops_a_pair.items()},
                 4 * (size * n + b * n) + 8 * b)


def const_bound(n: int, wrapped: bool, size: int = SIZE, b: int = B):
    return nn_bound(const_flops(n, wrapped), n, size, b)


def expand_bound(mode: str, n: int, wrapped: bool, size: int = SIZE,
                 b: int = B):
    return nn_bound(expand_flops(mode, n, wrapped), n, size, b)


def ptxas_summary(bodies=()):
    """One line per kernel instance from what ``ptxas -v`` said when the
    library was built (``_build.ptxas_log_path``): registers, shared
    memory and spills, with the kernel's name and template arguments (the
    state dimension; for ``stage_kernel`` the step body, named from
    ``bodies``, and whether it stores every step)."""
    from ..ops.kernels import _build

    path = _build.ptxas_log_path()
    out, name, spill = [], None, ""
    for line in (path.read_text() if path.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_(?:kernel|merge))"
                          r"(?:I((?:L[a-z]\d+E)+)E)?", m.group(1))
            args = re.findall(r"L[a-z](\d+)E", k.group(2) or "") if k else []
            if k is not None and k.group(1) == "stage_kernel" and bodies:
                args = [bodies[int(args[0])], f"store={args[1]}"]
            name = (m.group(1) if k is None else
                    k.group(1) + (f"<{','.join(args)}>" if args else ""))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} B smem, {spill}")
            name = None
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def l2_flush(dev, clean: bool = False):
    """A callable that writes FLUSH_BYTES on the card, evicting the L2.
    The L2 then holds the buffer's dirty lines, which the timed call
    writes back as it evicts them; with ``clean`` the callable reads a
    second such buffer after the write, so the L2 holds clean lines and
    the timed call moves only its own bytes."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    if not clean:
        return lambda: buf.fill_(1.0)
    other = torch.ones_like(buf)
    return lambda: (buf.fill_(1.0), other.sum())


def write_inputs(C: int, dev, seed: int = 5):
    g = torch.Generator(device=dev).manual_seed(seed)
    dst = torch.randn((100, C, N), generator=g, device=dev)
    src = torch.randn((100, C, B), generator=g, device=dev)
    return dst, src


def time_write(C: int, reps: int, dev="cuda") -> dict:
    """Kernel B and ``copy_`` alone, in turns (kernel, copy_, copy_,
    kernel), in each L2 condition; and each with its dispatch.  Each entry's
    ms is the mean of its two turns; ``turns`` keeps all four."""
    dst, src = write_inputs(C, dev)
    start = torch.tensor(B_START, dtype=torch.int32, device=dev)

    def kernel():
        block_write(dst, src, start)

    def copy():
        dst[..., B_START:B_START + B].copy_(src)

    out = {}
    conds = (("cold", l2_flush(dev)), ("cold_clean", l2_flush(dev, True)),
             ("warm", None))
    for cond, before in conds:
        turns = [device_ms(fn, reps, before)
                 for fn in (kernel, copy, copy, kernel)]
        out[cond] = dict(kernel_ms=(turns[0] + turns[3]) / 2,
                         copy_ms=(turns[1] + turns[2]) / 2, turns=turns)
    dev = torch.device(dev)
    out["wall"] = dict(kernel_ms=timed_ms(kernel, dev, reps),
                       copy_ms=timed_ms(copy, dev, reps))
    out["bytes"] = 2 * src.numel() * 4
    return out


def nn_inputs(n: int, wrap: int, dev, seed: int = 7):
    """Uniform states and candidates (the wrap dim over one turn, the rest
    over [-10, 10]) and a random SPD S_j a node."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.full((n,), 10.0, device=dev)
    scale[wrap] = math.pi
    states = (torch.rand((N, n), generator=g, device=dev) * 2 - 1) * scale
    xr = (torch.rand((B, n), generator=g, device=dev) * 2 - 1) * scale
    A = torch.randn((N, n, n), generator=g, device=dev) * 0.5
    S = A @ A.mT + 0.1 * torch.eye(n, device=dev)
    return states, S, xr


def time_nn(n: int, wrap: int, reps: int, dev="cuda") -> dict:
    """Kernel C's wrapper alone (prep included) and with its dispatch."""
    states, S, xr = nn_inputs(n, wrap, dev)
    size = torch.tensor(SIZE, dtype=torch.int32, device=dev)

    def call():
        nn_general(states, S, size, xr, wrap_dim=wrap)

    return dict(device_ms=device_ms(call, reps),
                wall_ms=timed_ms(call, torch.device(dev), reps))


def const_inputs(n: int, wrap: int, dev, seed: int = 7):
    """Kernel A's inputs (states (N, n), S (n, n), xr (B, n)): the boat's
    data and S at n = 6, else uniform states and candidates (the wrap dim,
    if any, over one turn, the rest over [-10, 10]) and a random SPD S."""
    if n == 6:
        states, S, _, xr = problem(dev, N, B, SIZE, seed)
        return states, S[0].contiguous(), xr
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.full((n,), 10.0, device=dev)
    if wrap is not None:
        scale[wrap] = math.pi
    states = (torch.rand((N, n), generator=g, device=dev) * 2 - 1) * scale
    xr = (torch.rand((B, n), generator=g, device=dev) * 2 - 1) * scale
    A = torch.randn((n, n), generator=g, device=dev) * 0.3
    return states, A @ A.T + 2.0 * torch.eye(n, device=dev), xr


def _launcher(fn, mode_args, states, S, xr, size, wrap):
    from ..ops.kernels.nn_kernel import EMPTY_KEY, _keyed_outputs, _launch

    n_rows, n = states.shape
    keys, ids, cost = _keyed_outputs(xr.shape[0], states.device)
    center = xr.mean(0)
    a = -1 if wrap is None else wrap

    def launch():
        _launch(fn, states, xr, S, center, size, keys, ids, cost, n_rows,
                xr.shape[0], n, *mode_args, a)

    return launch, lambda: keys.fill_(EMPTY_KEY)


def const_launcher(states, S, xr, size, wrap):
    """(launch, refill): kernel A's launch alone on these inputs (S (n, n)
    contiguous), and the refill of its keys, which each launch needs
    first (``device_ms``'s ``before``)."""
    return _launcher("lqrrt_nn_const", (), states, S, xr, size, wrap)


def expand_launcher(states, S, xr, size, wrap, mode: str):
    """(launch, refill): kernel E's launch alone in ``mode``, as
    ``const_launcher``.  On an older tree, whose kernel scans ``CHUNK``
    rows a block on features built in PyTorch and merges the blocks'
    partials in a second kernel, the launch is that tree's
    ``launch_expand`` (both kernels) on features prepared once
    (``expand_prep``), and there is nothing to refill."""
    if hasattr(nn_hybrid, "CHUNK"):
        p = nn_hybrid.expand_prep(states, S, xr, wrap)
        return (lambda: nn_hybrid.launch_expand(p, size, mode,
                                                wrap is not None)), None
    return _launcher("lqrrt_nn_expand", (nn_hybrid.MODES.index(mode),),
                     states, S, xr, size, wrap)


def prep_ms(xr, reps: int) -> float:
    """Device ms of kernels A's and E's prep alone: the candidate mean and
    the fill of the keys (2 ops)."""
    from ..ops.kernels.nn_kernel import _keyed_outputs

    return device_ms(lambda: (xr.mean(0),
                              _keyed_outputs(xr.shape[0], xr.device)), reps)


def _time(parts, call, reps, dev, launcher, xr, bound_ms):
    """The ``parts`` of one NN kernel's times (device ms), each beside its
    share of ``bound_ms``."""
    out = {"bound_ms": bound_ms}
    if "wrapper" in parts:
        out.update(device_ms=device_ms(call, reps),
                   wall_ms=timed_ms(call, torch.device(dev), reps))
    if "launch" in parts:
        launch, refill = launcher()
        out["launch_device_ms"] = device_ms(launch, reps, refill)
    if "prep" in parts:
        out["prep_device_ms"] = prep_ms(xr, reps)
    for k in ("device_ms", "launch_device_ms"):
        if k in out:
            out[k.replace("device_ms", "of_bound")] = bound_ms / out[k]
    return out


def time_const(n: int, wrap, reps: int, dev="cuda", parts=PARTS) -> dict:
    """Kernel A's ``parts``: the wrapper alone and with its dispatch, its
    launch alone, its prep alone."""
    states, S, xr = const_inputs(n, wrap, dev)
    size = torch.tensor(SIZE, dtype=torch.int32, device=dev)
    return _time(parts,
                 lambda: nn_const(states, S, size, xr, wrap_dim=wrap), reps,
                 dev, lambda: const_launcher(states, S, xr, size, wrap), xr,
                 const_bound(n, wrap is not None)[0])


def time_expand(mode: str, wrap, reps: int, dev="cuda",
                parts=PARTS) -> dict:
    """Kernel E's ``parts`` in ``mode`` on the boat's inputs, as
    ``time_const``'s."""
    states, S, _, xr = problem(dev, N, B, SIZE, 17)
    size = torch.tensor(SIZE, dtype=torch.int32, device=dev)
    prec = {"fma": "highest", "bf16": "default", "bf16x3": "high"}[mode]
    return _time(
        parts,
        lambda: nn_hybrid.nn_hybrid(states, S, size, xr, wrap_dim=wrap,
                                    prec=prec), reps, dev,
        lambda: expand_launcher(states, S[0].contiguous(), xr, size, wrap,
                                mode), xr,
        expand_bound(mode, states.shape[1], wrap is not None)[0])


def main(reps: int = 20, only=("A", "B", "C", "E"), parts=PARTS) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times: needs a CUDA card")
    card = smi_line()
    res = {"card": card, "write": {}, "nn_general": {}, "nn_const": {},
           "nn_expand": {}}

    def show(label, r):
        print(f"{label} [{card}]: "
              + ", ".join(f"{k} {v:.4f}" for k, v in r.items()), flush=True)

    if "A" in only:
        for n, wrap in ((6, 2), (4, 2), (12, 5)):
            r = time_const(n, wrap, reps, parts=parts)
            res["nn_const"][n] = r
            show(f"nn_const n={n} wrap={wrap} size={SIZE} ms", r)
    if "E" in only:
        for mode in nn_hybrid.MODES:
            for wrap in (2, None):
                r = time_expand(mode, wrap, reps, parts=parts)
                res["nn_expand"][f"{mode} wrap={wrap}"] = r
                show(f"nn_expand[{mode}] wrap={wrap} size={SIZE} ms", r)
    if "A" in only or "E" in only:
        for line in ptxas_summary():
            if line.startswith(("nn_const_kernel", "nn_expand_")):
                print(f"ptxas {line}", flush=True)
    for C in (6, 3) if "B" in only else ():
        r = time_write(C, reps)
        res["write"][C] = r
        bound_ms = bound(None, r["bytes"])[0]
        for cond in ("cold", "cold_clean", "warm"):
            v = r[cond]
            print(f"block_write C={C} L2 {cond} [{card}]: kernel alone "
                  f"{v['kernel_ms']:.4f} ms, copy_ alone {v['copy_ms']:.4f} "
                  f"ms (turns {', '.join(f'{t:.4f}' for t in v['turns'])}); "
                  f"bound {bound_ms:.4f} ms, kernel at "
                  f"{bound_ms / v['kernel_ms']:.1%}", flush=True)
        print(f"block_write C={C} with dispatch [{card}]: kernel "
              f"{r['wall']['kernel_ms']:.4f} ms, copy_ "
              f"{r['wall']['copy_ms']:.4f} ms", flush=True)
    for n, wrap in ((4, 2), (12, 5)) if "C" in only else ():
        r = time_nn(n, wrap, reps)
        res["nn_general"][n] = r
        print(f"nn_general n={n} size={SIZE} [{card}]: alone "
              f"{r['device_ms']:.4f} ms, with dispatch {r['wall_ms']:.4f} "
              "ms", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="A,B,C,E",
                    help="kernels to time, comma-separated")
    only_one = ap.add_mutually_exclusive_group()
    only_one.add_argument("--wrappers-only", action="store_true",
                          help="A, E: time the wrappers' public calls only")
    only_one.add_argument("--launches-only", action="store_true",
                          help="A, E: time the launches alone only")
    a = ap.parse_args()
    main(a.reps, tuple(a.only.split(",")),
         ("wrapper",) if a.wrappers_only else
         ("launch",) if a.launches_only else PARTS)
