"""Kernels A, B, C, D and E, F2's and F3's stages and F4's probes B and C
alone on the card, at the planner's and the experiments' shapes.

    python -m lqrrt_tpu_torch.tools.kernel_times [--reps 20]
        [--only A,B,C,D,E,F2,F3,F4] [--wrappers-only | --launches-only]

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

D, the fused steer rollout (``steer_kernel``), on ``chip_smoke.py``'s
phase D data (``steer_inputs``: ``branch_batch`` at B = 8192, seed 19, H =
100, a tree of N = 40960 rows): flat and tree at block 64 and F1
(``make_steer_kernel_dv``) at batch tiles 512 and 1024, each alone and
with its dispatch beside its share of the bound (``steer_bound``), and
whether it equals the plain steer on the card bit for bit; then the
rollout's registers and spills.  F4, the scaffold probes B and C (``scaffold_probes.probe``) at
the tool's B = 1024 and at B = 1027, alone and with dispatch, beside
their plain versions (B's is the one PyTorch call
``x.expand(H, 6, B).contiguous()``, C's a Python loop of H multiplies)
and their bounds (``probe_work``), with the same bit-for-bit check.
``--wrappers-only`` also runs D and F4 on an older tree.

F2 and F3, the stage scaffold (``steer_stages.build`` and ``run_stage``):
each of F2's twelve stages at B = 8192 on the tool's data
(``exp_steer_stages.stage_inputs``, seed 0) and each of F3's six at
B = 1024 on all ones and on ``dbg_steer_kernel.branch_inputs`` (seed 0),
alone and with its dispatch, beside its bound (``stage_bound``: its bytes
and ``steer_stages.FLOPS`` over the steps this data needs,
``stage_steps``) and its share of it, with the bit-for-bit check against
the plain version on the card; then the registers and spills of every
``stage_kernel`` instance.  There is only the wrapper's call to time, so
every mode times the same, and it also runs on an older tree.

Every line names the card (``nvidia-smi`` name and power limit).  The
device is the card: there is no CPU path.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess

import torch

import numpy as np

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
            # a type argument (steer_rollout_kernel<Car>) or one wrapped
            # once (steer_rollout_kernel<Raster<Car>>): its name
            t = re.search(r"_kernelIN(?:S_|12_GLOBAL__N_1)\d+([A-Za-z]+?)"
                          r"(?:IN(?:S_|12_GLOBAL__N_1)\d+([A-Za-z]+?)E)?EE",
                          m.group(1))
            if t:
                args = [t.group(1) if t.group(2) is None
                        else f"{t.group(1)}<{t.group(2)}>"]
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


def many_circles(k: int = 64, seed: int = 53):
    """(centers (k, 2), radii (k,)) float32: k - 7 seeded circles of radius
    0.2-0.5 m with centres in x [-10, 50] m, y [-30, 30] m, then the boat's
    default 7 buoys."""
    from ..models import boat

    centers, radii = boat.default_problem()["obstacles"]
    rng = np.random.default_rng(seed)
    more = np.column_stack([rng.uniform(-10.0, 50.0, k - len(radii)),
                            rng.uniform(-30.0, 30.0, k - len(radii))])
    return (np.concatenate([more, centers]).astype(np.float32),
            np.concatenate([rng.uniform(0.2, 0.5, k - len(radii)),
                            radii]).astype(np.float32))


def many_circles_problem(k: int = 64, seed: int = 53):
    """The boat's default problem with the circles of ``many_circles``
    (margin 1 m): the default buoys come last, so that ``branch_batch``'s
    buoy group stops on circles past the first 8."""
    from ..models import boat
    from ..ops import collision

    prob = boat.default_problem()
    constraints = copy.copy(prob["constraints"])
    constraints.set_feasibility_function(
        collision.circles_free(*many_circles(k, seed), margin=1.0))
    return dict(prob, constraints=constraints)


def circle_problems() -> dict:
    """{label: the boat's problem} at 0 circles (no obstacles: the all-true
    predicate), 7 (the default), 10 (``hard_problem``) and 64 (the most
    the rollout takes, ``many_circles_problem``)."""
    from ..models import boat

    return {"0 circles": boat.default_problem(obstacles=False),
            "7 circles": boat.default_problem(),
            "10 circles": boat.hard_problem(),
            "64 circles": many_circles_problem()}


def steer_inputs(dev, B: int = B, seed: int = 19, n_rows: int = N,
                 prob=None):
    """Kernel D's inputs, as ``chip_smoke.py``'s phase D makes them: the
    boat's problem (``prob``, by default ``default_problem()``),
    ``branch_batch(B, seed)`` (every branch of the step reached), its K
    tiled (KB), and a tree of ``n_rows`` rows holding the batch's x0 at
    distinct random rows (pids), each row with its own gain (the boat's K
    scaled by 0.5-1.5, KN).  A dict of device tensors, with the numpy x0
    and xtar, the circles' count and the raster's words (0 without one)."""
    from ..models import boat
    from ..ops.kernels.steer_kernel import pack_grid, predicate_parts
    from .exp_steer_kernel import boat_K, branch_batch, steer_args

    prob = boat.default_problem() if prob is None else prob
    args, kw = steer_args(prob)
    x0, xtar, _ = branch_batch(B, seed, prob)
    rng = np.random.default_rng(seed + 4)
    states = rng.uniform(-1.0, 1.0, (n_rows, 6)).astype(np.float32)
    pids = rng.permutation(n_rows)[:B].astype(np.int32)
    states[pids] = x0
    KN = (boat_K(prob) * rng.uniform(0.5, 1.5, (n_rows, 1, 1))).astype(
        np.float32)
    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        x0=x0, xtar=xtar, states=states, pids=pids, KN=KN,
        goal=prob["goal"]).items()}
    t["KB"] = torch.as_tensor(boat_K(prob), device=dev).expand(
        B, 3, 6).contiguous()
    circles, _, grid = predicate_parts(prob["constraints"].is_feasible)
    return dict(t, args=args, kw=kw, x0_np=x0, xtar_np=xtar,
                ncirc=len(circles),
                grid_words=0 if grid is None else len(pack_grid(grid[0])))


# per model: the erf's wrapped dims, the flops of one f (a clamp bound, a
# trig function and a division count one each) and the model's numbers
# (the kernel's params); the boat's f: sin, cos, 6 for pdot, 7 for the
# Coriolis terms, 15 for drag, 9 for nudot
STEER_MODELS = {
    # car: 2 clamps (4), sin, cos, tan, v c, v s, v tan, * 1 / WHEELBASE
    "boat": dict(wrap=1, f=39, params=14),
    "car": dict(wrap=1, f=11, params=7),
    # quadrotor: T (add, clamp: 3), tau (6), sin and cos of 3 angles (6),
    # R's third column (9), the pitch cosine's floor and tan p (2), the
    # Euler rates (14), acc (4), inertia w (3), the cross product (9),
    # w_dot (6)
    "quadrotor": dict(wrap=1, f=62, params=16),
    "double_integrator": dict(wrap=0, f=0, params=1),
}


def steer_bound(res, rows_read, ncirc, tree, model="boat", limits=False,
                grid_words=0):
    """(ms, what bounds it, flops, bytes) of one steer_rollout call of
    ``model`` (a key of STEER_MODELS), from its inputs and its outputs (the
    work depends on the data: a rollout runs until it is done).  Flops:
    the control of each state the rollout visits (length + 1 of them): the
    erf (n sub, 3 a wrapped dim: add, fmod, sub), the converged test (n
    mul, n - 1 add, sqrt, compare) and u = K e saturated (m x (n mul,
    n - 1 add, 2 clamp)), 61 for the boat; each active step the RK4 (4 f,
    3n for the stage states, 7n for the sum: 234 for the boat), 6 a circle,
    with ``limits`` (control_limits) 2m and with a raster of ``grid_words``
    words 10 (the cell: 2 sub, 2 mul, 2 floor; 4 bounds compares); each
    committed step the goal test (n sub, the wraps, n abs, n compare: 21).
    Bytes: xtar, the start rows read (x0 and K, or the distinct parents'
    rows and pids) and the small constants and the raster's words read
    once; xs, us, length, xnew, reached and in_goal written once."""
    H, n, nb = res.x_seq.shape
    m = res.u_seq.shape[1]
    spec = STEER_MODELS[model]
    w = spec["wrap"]
    control = 3 * n + 3 * w + 1 + m * (2 * n + 1)
    step = (4 * spec["f"] + 13 * n + 6 * ncirc
            + (2 * m if limits else 0) + (10 if grid_words else 0))
    length = res.length.long()
    active = torch.where(res.in_goal, length, (length + 1).clamp(max=H))
    flops = (int((length + 1).sum()) * control + int(active.sum()) * step
             + int(length.sum()) * (3 * n + 3 * w))
    nbytes = (4 * nb * n + 4 * rows_read * (n + m * n)
              + (4 * nb if tree else 0)
              + 4 * (3 * n + spec["params"] + 3 * ncirc
                     + (2 * m if limits else 0) + grid_words)
              + 4 * H * (n + m) * nb + nb * (4 + 4 * n + 2))
    return (*bound({"fp32": flops}, nbytes), flops, nbytes)


MODEL_GROUPS = ("uniform", "near", "goal", "uniform")


def model_steer_inputs(prob, dev, B: int = B, seed: int = 23,
                       n_rows: int = N):
    """Kernel D's inputs for a model's ``default_problem()`` dict, drawn
    from a seeded ``torch.Generator`` on ``dev``: x0 and xtar uniform in
    the sample space; candidate b in group ``MODEL_GROUPS[b % 4]``: near
    (xtar 0.02 from x0, inside the 0.05 tolerance: arrived at once) and goal
    (x0 0.5-2.5 m short of the goal in x, the rest of the goal's state, and
    xtar the goal: the goal stop); uniform rows reach the circles and the
    full horizon.  K is the model's own ``lqr`` at x0 (KB) and at every
    row of a tree of ``n_rows`` states uniform in the sample space, which
    holds the batch's x0 at distinct random rows pids (KN).  A dict of
    device tensors with the steer's arguments (H = horizon / dt, error_tol
    0.05, the goal box and ``saturate``) and the circles' count."""
    from ..ops.kernels.steer_kernel import predicate_parts

    g = torch.Generator(device=dev).manual_seed(seed)
    ss = torch.as_tensor(prob["sample_space"], device=dev)
    n, m = prob["constraints"].nstates, prob["constraints"].ncontrols
    goal = torch.as_tensor(prob["goal"], device=dev)

    def uniform(k):
        return ss[:, 0] + torch.rand((k, n), generator=g, device=dev) * (
            ss[:, 1] - ss[:, 0])

    x0, xtar = uniform(B), uniform(B)
    group = torch.arange(B, device=dev) % len(MODEL_GROUPS)
    d = torch.randn((B, n), generator=g, device=dev)
    near = x0 + 0.02 * d / d.norm(dim=1, keepdim=True)
    short = goal.expand(B, n).clone()
    short[:, 0] -= 0.5 + 2.0 * torch.rand(B, generator=g, device=dev)
    x0 = torch.where((group == 2)[:, None], short, x0)
    xtar = torch.where((group == 1)[:, None], near,
                       torch.where((group == 2)[:, None], goal, xtar))
    states = uniform(n_rows)
    pids = torch.randperm(n_rows, generator=g, device=dev)[:B]
    states[pids] = x0
    H = max(int(round(prob["horizon"] / prob["dt"])), 1)
    args = (prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
            H, prob["dt"], 0.05)
    kw = dict(saturate=prob["saturate"],
              goal_buffer=prob["constraints"].goal_buffer)
    circles, box, _ = predicate_parts(prob["constraints"].is_feasible)

    def gains(x):
        return prob["lqr"](x, torch.zeros(m, device=dev))[1].expand(
            len(x), m, n).contiguous()

    return dict(x0=x0.contiguous(), xtar=xtar.contiguous(), KB=gains(x0),
                states=states, KN=gains(states), pids=pids.int(), goal=goal,
                args=args, kw=kw, ncirc=len(circles), limits=box is not None)


def model_branch_counts(res) -> dict:
    """How many candidates of a SteerResult took each branch: the goal
    stop, the arrived stop (reached, short of H), the infeasible stop (not
    reached, short of H), the full horizon, and held (stopped, the rest of
    the horizon holding the last state and u)."""
    H = res.x_seq.shape[0]
    stopped = res.length < H
    return {"goal stop": int(res.in_goal.sum()),
            "arrived stop": int((~res.in_goal & res.reached
                                 & stopped).sum()),
            "infeasible stop": int((~res.in_goal & ~res.reached
                                    & stopped).sum()),
            "full horizon": int((~res.in_goal & ~stopped).sum()),
            "held": int(stopped.sum())}


def probe_work(name, b, H):
    """(fp32 flops, bytes) of one scaffold probe on (6, b): x read once,
    its constant read once, the output written once; the flops of its
    expression."""
    ns = 6
    out = {"B": H * ns * b, "C": H * ns * b, "D": b, "E": b}.get(name,
                                                                 ns * b)
    aux = {"F": ns, "G": 14}.get(name, 0)
    flops = {"A": ns * b, "B": 0, "C": H * ns * b, "D": 5 * b,
             "E": H * b * (5 + 1 + ns), "F": ns * b,
             "G": 13 + ns * b}[name]
    return flops, 4 * (ns * b + aux + out)


# the stages whose select can keep x (full, dbg_feasibility, dbg_full):
# once a step fails, every later step repeats it
HELD = ("full", "dbg_feasibility", "dbg_full")


def first_hold(x0T, xs):
    """(B,) int64: each candidate's first step whose stored x is the x it
    started from (H if none), where a stage of ``HELD`` failed and held x;
    x0T (n, B), xs (H, n, B)."""
    H = xs.shape[0]
    same = (xs == torch.cat([x0T[None], xs[:-1]])).all(1)
    return torch.where(same.any(0), same.int().argmax(0),
                       torch.full_like(same[0], H, dtype=torch.long))


def stage_steps(stage, x0T, xs) -> int:
    """The candidate-steps one call of a scaffold stage computes on these
    inputs: H a candidate, but in the stages of ``HELD`` each candidate's
    steps up to its first failed one (``first_hold``), which every later
    step repeats."""
    H, _, nb = xs.shape
    if stage not in HELD:
        return H * nb
    return int((first_hold(x0T, xs) + 1).clamp(max=H).sum())


def stage_bound(stage, B, H=100, steps=None):
    """(ms, what bounds it) of one call of a scaffold stage (F2, F3): the
    inputs x0T, KT and tarT read once, xs (and F2's us) written every step
    (only the final step's without per-step stores), length written once;
    the flops of the stage's body (``steer_stages.FLOPS``) in each of
    ``steps`` candidate-steps (``stage_steps``; by default B H)."""
    from ..ops.kernels import steer_stages as S

    rows = 6 + (3 if S.STAGES[stage].tool == "F2" else 0)
    stored = 1 if stage == "identity_nostore" else H
    nbytes = 4 * B * (6 + 3 * 6 + 6) + 4 * stored * rows * B + 4 * B
    return bound({"fp32": S.FLOPS[stage] * (B * H if steps is None
                                            else steps)}, nbytes)


def stage_geometry(b: int):
    """(threads, blocks) of the scaffold's launch at B = b on the card: D's
    ``rollout_geometry``, or an older tree's fixed ``BLOCK``."""
    from ..ops.kernels import steer_stages as S
    from ..ops.kernels.nn_kernel import sm_count
    from ..ops.kernels.steer_kernel import rollout_geometry

    if hasattr(S, "BLOCK"):
        return S.BLOCK, -(-b // S.BLOCK)
    return rollout_geometry(b, sm_count(torch.device("cuda")))


def stage_calls(dev, only=("F2", "F3")):
    """{label: (stage, the wrapper, its inputs)} of the scaffold: F2's
    stages at B = 8192 on the tool's data (``stage_inputs``, seed 0), F3's
    at B = 1024 on all ones and on ``branch_inputs`` (seed 0)."""
    from ..ops.kernels import steer_stages as S
    from .dbg_steer_kernel import branch_inputs
    from .exp_steer_stages import stage_inputs

    out = {}
    if "F2" in only:
        ins = stage_inputs(B, 0, dev)
        for stage in S.F2:
            out[f"F2 {stage} B={B}"] = (stage, S.build(stage), ins)
    if "F3" in only:
        b3 = 1024
        f3_ins = {"ones": [torch.ones(sh, device=dev) for sh in
                           ((6, b3), (3, 6, b3), (6, b3))],
                  "branches": branch_inputs(b3, 0, dev)}
        for stage in S.F3:
            for what, ins in f3_ins.items():
                out[f"F3 {stage} {what} B={b3}"] = (stage, S.run_stage(stage),
                                                   ins)
    return out


def stage_exact(stage, res, ref) -> bool:
    """A stage's outputs on the card equal its plain version's, bit for
    bit (NaN equal to NaN): xs, F2's us and the length; only index 0 of xs
    and us for identity_nostore, which stores nothing else."""
    from .dbg_steer_kernel import same

    sl = slice(0, 1) if stage == "identity_nostore" else slice(None)
    pairs = [(res[0][sl], ref[0][sl]), (res[-1], ref[2])]
    if len(res) == 3:
        pairs.append((res[1][sl], ref[1][sl]))
    return all(same(a, b) for a, b in pairs)


def time_stages(reps: int, dev="cuda", only=("F2", "F3")) -> dict:
    """F2's and F3's stages (``stage_calls``) alone and with their
    dispatch, each beside its bound and share of it, with the bit-for-bit
    check against the plain version on the card."""
    from ..ops.kernels import steer_stages as S

    out = {}
    for label, (stage, fn, ins) in stage_calls(dev, only).items():
        res, ref = fn(*ins), S.plain(stage, *ins)
        nb = ins[0].shape[1]
        bms = stage_bound(stage, nb, S.H, stage_steps(stage, ins[0],
                                                      res[0]))[0]
        r = dict(device_ms=device_ms(lambda: fn(*ins), reps),
                 wall_ms=timed_ms(lambda: fn(*ins), torch.device(dev), reps),
                 bound_ms=bms, bit_exact=float(stage_exact(stage, res, ref)))
        r["of_bound"] = bms / r["device_ms"]
        out[label] = r
    return out


def same_result(res, ref) -> bool:
    """Every field of two SteerResults equal (torch.equal)."""
    return all(torch.equal(a, b) for a, b in zip(res, ref))


def same_result_nan(res, ref) -> bool:
    """Every field of two SteerResults equal, NaN equal to NaN (a NaN gain
    of the model's lqr gives NaN rows on both sides)."""
    return all(torch.equal(a.isnan(), b.isnan())
               and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
               if a.is_floating_point() else torch.equal(a, b)
               for a, b in zip(res, ref))


def steer_calls(t):
    """{label: (the wrapper's call, the plain steer's call)} of kernel D
    on ``steer_inputs``: flat and tree at block 64, F1 at batch tiles 512
    and 1024."""
    from ..core.steer import make_steer
    from ..ops.kernels.steer_kernel import (make_steer_kernel,
                                            make_steer_kernel_dv,
                                            make_steer_kernel_tree)

    args, kw = t["args"], t["kw"]
    plain = make_steer(*args, **kw)
    flat = make_steer_kernel(*args, block=64, **kw)
    tree = make_steer_kernel_tree(*args, block=64, **kw)
    x0, KB, xtar, goal = t["x0"], t["KB"], t["xtar"], t["goal"]
    idx = t["pids"].long()

    def plain_flat():
        return plain(x0, KB, xtar, goal)

    calls = {"flat": (lambda: flat(x0, KB, xtar, goal), plain_flat),
             "tree": (lambda: tree(t["states"], t["KN"], t["pids"], xtar,
                                   goal),
                      lambda: plain(t["states"][idx], t["KN"][idx], xtar,
                                    goal))}
    for bt in (512, 1024):
        dv = make_steer_kernel_dv(*args, batch_tile=bt, **kw)
        calls[f"dv{bt}"] = ((lambda dv=dv: dv(x0, KB, xtar, goal)),
                            plain_flat)
    return calls


def time_steer(reps: int, dev="cuda") -> dict:
    """Kernel D's and F1's calls (``steer_calls``) alone and with their
    dispatch, each with its bound's share and its bit-for-bit check."""
    t = steer_inputs(dev)
    out = {}
    for label, (call, plain_call) in steer_calls(t).items():
        res, ref = call(), plain_call()
        rows = (int(torch.unique(t["pids"]).numel()) if label == "tree"
                else B)
        bms, by = steer_bound(res, rows, t["ncirc"], label == "tree")[:2]
        r = dict(device_ms=device_ms(call, reps),
                 wall_ms=timed_ms(call, torch.device(dev), reps),
                 bound_ms=bms, bit_exact=float(same_result(res, ref)))
        r["of_bound"] = bms / r["device_ms"]
        out[label] = r
    return out


def time_probes(reps: int, dev="cuda") -> dict:
    """F4's probes B and C at B = 1024 and 1027, alone and with dispatch,
    beside their plain versions, each with its bound (``probe_work``) and
    the bit-for-bit check."""
    from ..ops.kernels import scaffold_probes as P

    out = {}
    for b in (1024, 1027):
        x = torch.randn((6, b), generator=torch.Generator(device=dev)
                        .manual_seed(b), device=dev)
        for name in ("B", "C"):
            bms = bound(None, probe_work(name, b, P.H)[1])[0]
            for who, fn in (("kernel", P.probe), ("plain", P.plain)):
                def call(fn=fn, name=name):
                    return fn(name, x)

                r = dict(device_ms=device_ms(call, reps),
                         wall_ms=timed_ms(call, torch.device(dev), reps),
                         bound_ms=bms)
                r["of_bound"] = bms / r["device_ms"]
                if who == "kernel":
                    r["bit_exact"] = float(torch.equal(P.probe(name, x),
                                                       P.plain(name, x)))
                out[f"{name} B={b} {who}"] = r
    return out


def main(reps: int = 20, only=("A", "B", "C", "D", "E", "F2", "F3", "F4"),
         parts=PARTS) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times: needs a CUDA card")
    card = smi_line()
    res = {"card": card, "write": {}, "nn_general": {}, "nn_const": {},
           "nn_expand": {}, "steer_rollout": {}, "steer_stages": {},
           "scaffold_probes": {}}

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
    if "D" in only:
        res["steer_rollout"] = time_steer(reps)
        for label, r in res["steer_rollout"].items():
            show(f"steer_rollout {label} B={B} H=100 ms", r)
        for line in ptxas_summary():
            if line.startswith("steer_rollout_kernel"):
                print(f"ptxas {line}", flush=True)
    if "F2" in only or "F3" in only:
        from ..ops.kernels.steer_stages import BODIES

        res["steer_stages"] = time_stages(reps, only=only)
        for label, r in res["steer_stages"].items():
            show(f"steer_stage {label} H=100 ms", r)
        res["steer_stages_geometry"] = {b: stage_geometry(b)
                                        for b in (B, 1024)}
        print(f"steer_stage (threads, blocks) by B: "
              f"{res['steer_stages_geometry']}", flush=True)
        for line in ptxas_summary(BODIES):
            if line.startswith("stage_kernel"):
                print(f"ptxas {line}", flush=True)
    if "F4" in only:
        res["scaffold_probes"] = time_probes(reps)
        for label, r in res["scaffold_probes"].items():
            show(f"scaffold_probe {label} H=100 ms", r)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="A,B,C,D,E,F2,F3,F4",
                    help="kernels to time, comma-separated")
    only_one = ap.add_mutually_exclusive_group()
    only_one.add_argument("--wrappers-only", action="store_true",
                          help="A, E: time the wrappers' public calls only "
                          "(D, F2, F3 and F4 time only those)")
    only_one.add_argument("--launches-only", action="store_true",
                          help="A, E: time the launches alone only")
    a = ap.parse_args()
    main(a.reps, tuple(a.only.split(",")),
         ("wrapper",) if a.wrappers_only else
         ("launch",) if a.launches_only else PARTS)
