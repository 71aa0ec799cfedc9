"""Kernel D's circles test in two forms, timed in turns on the card.

    python -m lqrrt_tpu_torch.tools.exp_rollout_circles [--reps 20]

``committed`` is ``csrc/steer_rollout.cu`` as it stands; ``other`` is the
same source with the circles test in the other form (``OTHER``: the first
8 circles held in registers and the rest read from shared memory, against
one loop over shared memory).  Each is built from its own copy of
``csrc/`` into ``lqrrt_tpu_torch/_build/`` (the library's name is the
sources' hash) and prints its rollout's registers and spills.  Then, at
B = 8192, H = 100 on ``kernel_times.steer_inputs`` (``branch_batch``, seed
19) for each problem of ``kernel_times.circle_problems`` (0, 7, 10 and 64
circles), the flat steer at block 64 alone (``device_ms``) in turns,
committed, other, other, committed, each checked against the plain steer
on the card bit for bit (every field of the SteerResult).  The card's
name and power limit head the output.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import shutil

import torch

from ..ops.kernels import _build
from ..ops.kernels.steer_kernel import make_steer_kernel
from ..core.steer import make_steer
from .exp_steer_kernel import device_ms
from .kernel_times import (B, N, circle_problems, ptxas_summary,
                           same_result, smi_line, steer_inputs)

# (text of csrc/steer_rollout.cu, its replacement): the other form
OTHER = [
    ("""  float cr[boat::kRegCircles][3];
  boat::load_circles(cs, ncirc, cr);
""", ""),
    ("""        const bool feas = boat::circles_ok(cr, cs, ncirc, xn[0], xn[1]);
""", """        const bool feas = boat::circles_clear(cs, 0, ncirc, xn[0], xn[1]);
"""),
]


# the committed sources, which every copy starts from (the tools point
# _build.CSRC at a copy while they build it)
COMMITTED = _build.CSRC


def source_copy(name: str, patches=(), file: str = "steer_rollout.cu"):
    """A copy of the committed ``csrc/`` under ``_build/exp_<name>/`` with
    ``patches`` applied to ``file`` (each text found exactly once)."""
    dst = _build.BUILD_DIR / f"exp_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(COMMITTED, dst)
    src = dst / file
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"source_copy: the patch's text is not in "
                               f"{file} once:\n{old}")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def main(reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_rollout_circles: needs a CUDA card")
    card = smi_line()
    print(card, flush=True)
    csrc, lib = _build.CSRC, _build._lib
    libs = {}
    try:
        for name, patches in (("committed", ()), ("other", OTHER)):
            _build.CSRC, _build._lib = source_copy(name, patches), None
            libs[name] = _build.lib()
            for line in ptxas_summary():
                if line.startswith("steer_rollout_kernel"):
                    print(f"{name} ptxas {line}", flush=True)
        res = {}
        for label, prob in circle_problems().items():
            t = steer_inputs("cuda", B, 19, N, prob)
            args, kw = t["args"], t["kw"]
            x0, KB, xtar, goal = t["x0"], t["KB"], t["xtar"], t["goal"]
            flat = make_steer_kernel(*args, block=64, **kw)
            ref = make_steer(*args, **kw)(x0, KB, xtar, goal)
            turns = []
            for name in ("committed", "other", "other", "committed"):
                _build._lib = libs[name]
                same = same_result(flat(x0, KB, xtar, goal), ref)
                ms = device_ms(lambda: flat(x0, KB, xtar, goal), reps)
                turns.append(dict(variant=name, device_ms=ms,
                                  bit_exact=same))
                print(f"{label} {name}: alone {ms:.4f} ms, "
                      f"bit_exact={same} [{card}]", flush=True)
            res[label] = turns
    finally:
        _build.CSRC, _build._lib = csrc, lib
    print(json.dumps({"card": card, "turns": res}), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    main(ap.parse_args().reps)
