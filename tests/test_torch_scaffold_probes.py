"""Kernel F4's plain versions against the JAX tool (CPU): the seven scaffold
probes of ``lqrrt_tpu_torch/ops/kernels/scaffold_probes.py`` against the
kernels that tools/dbg_steer_scaffold.py runs when it is loaded, in
interpret mode, on the tool's all-ones inputs (x (6, 1024), g (6,), a
(7, 2) constant, H = 100): bit for bit, dtype and shape included.  The
tool is a script: its source runs in a fresh module with ``pallas_call``
in interpret mode (``load_tool`` of tests/test_torch_steer_stages.py).
The CUDA kernels run only on the card (``chip_smoke.py``); on CPU tensors
``probe`` takes the plain version."""
import functools

import numpy as np
import pytest
import torch

from test_torch_steer_stages import load_tool

from lqrrt_tpu_torch.ops.kernels import scaffold_probes
from lqrrt_tpu_torch.ops.kernels.scaffold_probes import (H, PROBES, plain,
                                                         probe,
                                                         probe_geometry)
from lqrrt_tpu_torch.tools import dbg_steer_scaffold
from lqrrt_tpu_torch.tools.dbg_steer_scaffold import probe_args


B_RAGGED = 1027      # not a multiple of 4, nor of the tool's tile
SMS = 132            # the H100's SMs


@functools.lru_cache(maxsize=None)
def tool(B=1024):
    """tools/dbg_steer_scaffold.py, which runs its seven probes when it is
    loaded; their outputs are in ``.recorded``.  At another B than its
    1024 the tool's tile is the whole batch (one block, as its grid
    B // Bt needs)."""
    if B == 1024:
        return load_tool("dbg_steer_scaffold.py")
    return load_tool("dbg_steer_scaffold.py", replace={
        "H, n, B, Bt = 100, 6, 1024, 256": f"H, n, B, Bt = 100, 6, {B}, {B}"})


@pytest.mark.parametrize("i,name", list(enumerate(PROBES)))
def test_probe_matches_tool_interpret(i, name):
    ref = np.asarray(tool().recorded[i])
    launches = dict(scaffold_probes.LAUNCHES)
    y = probe(name, *probe_args(name, "cpu")).numpy()
    assert scaffold_probes.LAUNCHES == launches   # the CPU launches nothing
    assert y.dtype == ref.dtype and y.shape == ref.shape
    np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("i,name", list(enumerate(PROBES)))
def test_probe_matches_tool_interpret_ragged(i, name):
    """The same at B = 1027, the ragged batch of chip_smoke.py's phase."""
    ref = np.asarray(tool(B_RAGGED).recorded[i])
    y = probe(name, *probe_args(name, "cpu", B_RAGGED)).numpy()
    assert y.dtype == ref.dtype and y.shape == ref.shape
    assert ref.shape[-1] == B_RAGGED
    np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("B", [1, 31, 1024, 1027, 8191, 8192])
@pytest.mark.parametrize("name,aligned", [("B", True), ("B", False),
                                          ("C", True)])
def test_probe_geometry_covers_each_element_once(name, aligned, B):
    """probe_geometry's grid for the two probes that write (H, 6, B):
    thread e of grid row y takes elements [vec e, vec (e + 1)) of x at
    steps [y h_per, (y + 1) h_per); every (step, element) exactly once,
    float4s only where 6B is a multiple of 4 and the pointers aligned, no
    block without work, and the blocks reach every SM where there is work
    enough."""
    threads, bx, by, h_per, vec = probe_geometry(name, B, SMS, aligned)
    n = 6 * B
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert vec == (4 if name == "B" and aligned and n % 4 == 0 else 1)
    hits = np.zeros((H, n), np.int64)
    e = np.arange(bx * threads)
    e = e[e * vec < n]
    cols = (e[:, None] * vec + np.arange(vec)).ravel()
    for y in range(by):
        hits[y * h_per:min(H, (y + 1) * h_per), cols] += 1
    np.testing.assert_array_equal(hits, 1)
    assert (bx - 1) * threads * vec < n and (by - 1) * h_per < H
    if name == "C" or n >= SMS * 32:
        assert bx * by >= min(SMS, -(-n // 32))


@pytest.mark.parametrize("name", PROBES)
def test_probe_plain_on_other_data(name):
    """The plain versions compute the tool's expressions on data other
    than ones (a numpy seed), where the order of a sum shows."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    aux = {"F": (6,), "G": (7, 2)}.get(name)
    args = (x,) if aux is None else (
        torch.from_numpy(rng.standard_normal(aux).astype(np.float32)), x)
    y = plain(name, *args).numpy()
    xn = x.numpy()
    want = {
        "A": lambda: xn * 2.0,
        "B": lambda: np.broadcast_to(xn, (100, 6, 64)),
        "C": lambda: np.stack([xn * np.float32(1.01) ** (h + 1)
                               for h in range(100)]),
        "D": lambda: xn.sum(0),
        "F": lambda: xn + args[0].numpy()[:, None],
        "G": lambda: xn + args[0].numpy().sum(),
    }
    if name == "E":           # |sum| of N(0, 1) rows stays far below 1e9
        np.testing.assert_array_equal(y, np.zeros(64, np.int32))
    else:
        np.testing.assert_allclose(y, want[name](), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["unknown", "float64", "shape", "aux-shape",
                                 "non-contiguous", "device"])
def test_probe_checks_its_inputs(bad):
    x = torch.ones((6, 32))
    with pytest.raises((TypeError, ValueError)):
        if bad == "unknown":
            probe("H", x)
        elif bad == "float64":
            probe("A", x.double())
        elif bad == "shape":
            probe("A", torch.ones((5, 32)))
        elif bad == "aux-shape":
            probe("G", torch.ones((2, 7)), x)
        elif bad == "non-contiguous":
            probe("D", torch.ones((32, 6)).T)
        else:
            probe("F", torch.ones(6, device="meta"), x)


def test_entry_point_main_on_cpu(capsys):
    assert dbg_steer_scaffold.main(device="cpu") == 0
    printed = capsys.readouterr().out
    for name in scaffold_probes.NAMES.values():
        assert f"{name}: OK" in printed
    with pytest.raises(RuntimeError, match="CUDA"):
        dbg_steer_scaffold.main(device="cuda")
