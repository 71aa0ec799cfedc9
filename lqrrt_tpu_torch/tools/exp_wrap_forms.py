"""The erf's wrap (``wrap_angle_fast`` in csrc/boat_device.cuh) in three
forms, timed in turns on the card in kernel D and the stage scaffold.

    python -m lqrrt_tpu_torch.tools.exp_wrap_forms [--reps 20]

All three give the bits of ``fmodf`` and so of ``ops/angles.py``'s
``wrap_angle``; they differ in what a warp runs:

- ``selects`` is ``csrc/`` as it stands: two selects (4 pi, then 2 pi)
  and ``fmodf`` only where |a + pi| >= 8 pi;
- ``three_way``: a nested select, a + pi itself below 2 pi, one
  subtraction of 2 pi below 4 pi, else ``fmodf``, which some lanes of a
  warp take as a branch;
- ``fmodf``: ``fmodf`` on every lane.

Each is built from its own copy of ``csrc/`` into
``lqrrt_tpu_torch/_build/`` (``exp_rollout_circles.source_copy``; the
library's name is the sources' hash).  Then in turns, selects, three_way,
fmodf, fmodf, three_way, selects: kernel D flat and tree and F1 at tiles
512 and 1024 at B = 8192 on ``kernel_times.steer_inputs`` (``branch_batch``,
seed 19, where |e + pi| stays below 4 pi on nearly every lane), and the
scaffold's stages that take the erf (``kernel_times.stage_calls``: F2 at
B = 8192 on the tool's data, whose psi targets of 5 N(0, 1) put some lanes
of most warps past 4 pi; F3 at B = 1024 on all ones and
``branch_inputs``), each alone (``device_ms``) and checked against its
plain version on the card bit for bit.  The card's name and power limit
head the output.  Needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import _build
from ..ops.kernels import steer_stages as S
from ..utils.device import smi_line
from .exp_rollout_circles import source_copy
from .exp_steer_kernel import device_ms
from .kernel_times import (ptxas_summary, same_result, stage_calls,
                           stage_exact, steer_calls, steer_inputs)

# the body of wrap_angle_fast that picks r, as it stands, and in the others
SELECTS = """\
  float r = fabsf(s) >= four_pi ? sub(s, copysignf(four_pi, s)) : s;
  r = fabsf(r) >= two_pi ? sub(r, copysignf(two_pi, r)) : r;
  if (!(fabsf(s) < 2.0f * four_pi)) r = fmodf(s, two_pi);
"""
FORMS = {
    "selects": SELECTS,
    "three_way": """\
  const float m = fabsf(s);
  float r = m < two_pi                ? s
            : m < four_pi             ? sub(s, copysignf(two_pi, s))
                                      : fmodf(s, two_pi);
""",
    "fmodf": """\
  float r = fmodf(s, two_pi);
""",
}
TURNS = ("selects", "three_way", "fmodf", "fmodf", "three_way", "selects")
# the scaffold's stages that take the erf
ERF_STAGES = ("erf", "matvec", "saturate", "dynamics", "full", "dbg_erf",
              "dbg_matvec", "dbg_dynamics", "dbg_feasibility", "dbg_full")


def main(reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_wrap_forms: needs a CUDA card")
    card = smi_line()
    print(card, flush=True)
    csrc, lib = _build.CSRC, _build._lib
    libs = {}
    try:
        for name, body in FORMS.items():
            patches = () if body == SELECTS else ((SELECTS, body),)
            _build.CSRC = source_copy(f"wrap_{name}", patches,
                                      "boat_device.cuh")
            _build._lib = None
            libs[name] = _build.lib()
            for line in ptxas_summary(S.BODIES):
                if line.startswith(("steer_rollout_kernel",
                                    "stage_kernel<full,")):
                    print(f"{name} ptxas {line}", flush=True)
        t = steer_inputs("cuda")
        calls = {f"D {k}": (call, plain, same_result)
                 for k, (call, plain) in steer_calls(t).items()}
        for label, (stage, fn, ins) in stage_calls("cuda").items():
            if stage in ERF_STAGES:
                calls[label] = ((lambda fn=fn, ins=ins: fn(*ins)),
                                (lambda stage=stage, ins=ins:
                                 S.plain(stage, *ins)),
                                (lambda a, b, stage=stage:
                                 stage_exact(stage, a, b)))
        refs = {label: plain() for label, (_, plain, _) in calls.items()}
        res = {label: [] for label in calls}
        for name in TURNS:
            _build._lib = libs[name]
            for label, (call, _, exact) in calls.items():
                same = exact(call(), refs[label])
                ms = device_ms(call, reps)
                res[label].append(dict(form=name, device_ms=ms,
                                       bit_exact=same))
        for label, turns in res.items():
            mean = {n: sum(r["device_ms"] for r in turns if r["form"] == n)
                    / 2 for n in FORMS}
            print(f"{label}: alone, mean of two turns, "
                  + ", ".join(f"{n} {ms:.4f} ms" for n, ms in mean.items())
                  + f"; bit_exact={all(r['bit_exact'] for r in turns)} "
                  f"[{card}]", flush=True)
    finally:
        _build.CSRC, _build._lib = csrc, lib
    print(json.dumps({"card": card, "turns": res}), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    main(ap.parse_args().reps)
