"""The seven scaffold probes (port of tools/dbg_steer_scaffold.py, its
probes :30-100).

    python -m lqrrt_tpu_torch.tools.dbg_steer_scaffold [--device cuda]

The tool asked which kernel-structure element Mosaic rejected, printing
"<probe>: OK" or "<probe>: FAILED ...".  Here OK means that the probe's
kernel (``scaffold_probes.probe``) was built, launched and equal to its
plain version (the library call itself), bit for bit, on the tool's
inputs: x all ones (6, 1024), g ones (6,), a (7, 2) constant of ones, H =
100.  ``main`` returns the count of probes that failed.  The device is
explicit: ``device="cuda"`` needs a card; on the CPU the wrapper takes the
plain version (for tests).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops.kernels import scaffold_probes
from ..ops.kernels.scaffold_probes import NAMES, PROBES, plain, probe
from .dbg_steer_kernel import same

B = 1024


def probe_args(name: str, dev, B: int = B):
    """The tool's arguments of probe ``name``: all ones."""
    x = torch.ones((6, B), device=dev)
    aux = {"F": (6,), "G": (7, 2)}.get(name)
    return (x,) if aux is None else (torch.ones(aux, device=dev), x)


def main(device: str = "cuda") -> int:
    """Run the seven probes; print one line each, return the failures."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dbg_steer_scaffold: device='cuda' needs a CUDA "
                           "card")
    failures = 0
    for name in PROBES:
        try:
            args = probe_args(name, dev)
            before = scaffold_probes.LAUNCHES[name]
            y, ref = probe(name, *args), plain(name, *args)
            launched = dev.type == "cpu" or \
                scaffold_probes.LAUNCHES[name] > before
            if launched and same(y, ref):
                print(f"{NAMES[name]}: OK", flush=True)
                continue
            print(f"{NAMES[name]}: FAILED launched={launched} "
                  f"equal={same(y, ref)}", flush=True)
        except Exception as e:          # the tool's report: name the error
            print(f"{NAMES[name]}: FAILED {type(e).__name__}: "
                  f"{str(e)[:120]}", flush=True)
        failures += 1
    return failures


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    sys.exit(main(ap.parse_args().device))


if __name__ == "__main__":
    _cli()
