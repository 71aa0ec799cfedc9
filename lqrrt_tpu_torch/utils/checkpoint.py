"""Checkpoint / resume (port of lqrrt_tpu/utils/checkpoint.py), in the same
npz layout, so a checkpoint the JAX planner writes loads into this one.

A checkpoint holds the planner's mission state: the goal, the committed
plan (x_seq, u_seq, T), ``plan_reached_goal`` and, with
``include_tree=True``, every field of the device tree as ``tree_<field>``.
Callbacks are code and are not saved: ``load`` goes into a planner built
for the same problem, and checks its dimensions.

Random state.  The JAX package saves its PRNG key as ``key``; a JAX key
has no meaning to a ``torch.Generator``, so ``load`` reads it and drops it.
This package saves its generator's state in ``torch_gen_state``, with the
generator's device type in ``torch_gen_device`` (a CUDA generator's state
is its seed and offset, a CPU one's the Mersenne twister's), and
``load`` restores it into a planner on the same device type, so the
resumed planner draws the stream the saved one would have drawn; from a
JAX checkpoint or another device type the generator is left as it is.  So
that the JAX package can read this package's checkpoints, ``save`` writes
``key`` too, as the zero key (``jax.random.PRNGKey(0)``'s value).
"""
from __future__ import annotations

import numpy as np
import torch

# The layout's history (the JAX package's numbers):
#   2 - no tree_n_children (the 2 -> 3 migration rebuilds child counts)
#   3 - adds tree_n_children
#   4 - edge arrays stored time-major (H, ., N), not (N, H, .)
_FORMAT = 4
_COMPAT = (2, 3, 4)   # formats load() accepts (older ones via migration)


def save(planner, path: str, include_tree: bool = False):
    """Write the planner's mission state to ``path`` (.npz)."""
    from ..interop import tree_to_numpy

    gen = planner._gen
    data = dict(
        format=np.int64(_FORMAT),
        nstates=np.int64(planner.nstates),
        ncontrols=np.int64(planner.ncontrols),
        dt=np.float64(planner.dt),
        key=np.zeros(2, np.uint32),
        torch_gen_state=gen.get_state().numpy(),
        torch_gen_device=np.str_(gen.device.type),
        plan_reached_goal=np.bool_(planner.plan_reached_goal),
        has_plan=np.bool_(planner._plan is not None),
        has_goal=np.bool_(planner.goal is not None),
    )
    if planner.goal is not None:
        data["goal"] = planner.goal.cpu().numpy()
    if planner._plan is not None:
        x_seq, u_seq, T = planner._plan
        data["x_seq"] = np.asarray(x_seq)
        data["u_seq"] = np.asarray(u_seq)
        data["T"] = np.float64(T)
    if include_tree and planner._device_tree is not None:
        for field, a in tree_to_numpy(planner._device_tree).items():
            data[f"tree_{field}"] = a
    np.savez_compressed(path, **data)


def _migrate(fields: dict, fmt: int) -> dict:
    """Tree fields of an older format in format 4's layout."""
    if fmt < 4:
        # 3 -> 4: edge arrays were row-major (N, H, .)
        for f in ("edge_x", "edge_u"):
            fields[f] = np.transpose(fields[f], (1, 2, 0))
    if "n_children" not in fields:
        # 2 -> 3: counts rebuilt from the parent array, real edges only (a
        # zero-length row, the dense commit's copy of an empty rollout's
        # parent, never counts)
        parent, edge_len = fields["parent"], fields["edge_len"]
        size = int(fields["size"])
        counts = np.zeros(parent.shape[0], np.int32)
        rows = np.arange(size)
        ok = (rows >= 1) & (edge_len[:size] >= 1) & (parent[:size] >= 0)
        np.add.at(counts, parent[:size][ok], 1)
        fields["n_children"] = counts
    return fields


def load(planner, path: str):
    """Restore mission state saved by ``save`` (of either package) into
    ``planner``, whose dimensions must match; tensors land on the
    planner's device."""
    from ..interop import tree_from_numpy

    with np.load(path) as z:
        fmt = int(z["format"])
        if fmt not in _COMPAT:
            raise ValueError(f"checkpoint format {fmt} not in supported "
                             f"{_COMPAT}")
        if int(z["nstates"]) != planner.nstates or \
           int(z["ncontrols"]) != planner.ncontrols:
            raise ValueError(
                "checkpoint dims "
                f"({int(z['nstates'])}, {int(z['ncontrols'])}) do not match "
                f"planner ({planner.nstates}, {planner.ncontrols})")
        if ("torch_gen_state" in z.files
                and str(z["torch_gen_device"]) == planner._gen.device.type):
            planner._gen.set_state(torch.from_numpy(z["torch_gen_state"]))
        planner.plan_reached_goal = bool(z["plan_reached_goal"])
        if bool(z["has_goal"]):
            planner.set_goal(z["goal"])
        if bool(z["has_plan"]):
            planner._plan = (z["x_seq"].astype(np.float32),
                             z["u_seq"].astype(np.float32),
                             float(z["T"]))
        fields = {k[len("tree_"):]: z[k] for k in z.files
                  if k.startswith("tree_")}
    if fields:
        planner._device_tree = tree_from_numpy(_migrate(fields, fmt),
                                               device=planner.device)
        planner.tree = None
    return planner
