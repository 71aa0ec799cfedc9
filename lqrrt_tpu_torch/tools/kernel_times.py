"""Kernels B and C alone on the card, at the planner's shapes.

    python -m lqrrt_tpu_torch.tools.kernel_times [--reps 20]

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

Every line names the card (``nvidia-smi`` name and power limit).  The
device is the card: there is no CPU path.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..ops.kernels.nn_kernel import nn_general
from ..ops.kernels.write_kernel import block_write
from .exp_steer_kernel import device_ms, timed_ms

N, B = 40960, 8192
B_START = 512 + 8192     # the second batch's column block, as the planner's
SIZE = 32768
FLUSH_BYTES = 64 << 20   # larger than the H100's 50 MB L2


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


def main(reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times: needs a CUDA card")
    card = smi_line()
    res = {"card": card, "write": {}, "nn_general": {}}
    for C in (6, 3):
        r = time_write(C, reps)
        res["write"][C] = r
        bound = r["bytes"] / 3.35e12 * 1e3
        for cond in ("cold", "cold_clean", "warm"):
            v = r[cond]
            print(f"block_write C={C} L2 {cond} [{card}]: kernel alone "
                  f"{v['kernel_ms']:.4f} ms, copy_ alone {v['copy_ms']:.4f} "
                  f"ms (turns {', '.join(f'{t:.4f}' for t in v['turns'])}); "
                  f"bound {bound:.4f} ms, kernel at "
                  f"{bound / v['kernel_ms']:.1%}", flush=True)
        print(f"block_write C={C} with dispatch [{card}]: kernel "
              f"{r['wall']['kernel_ms']:.4f} ms, copy_ "
              f"{r['wall']['copy_ms']:.4f} ms", flush=True)
    for n, wrap in ((4, 2), (12, 5)):
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
    main(ap.parse_args().reps)
