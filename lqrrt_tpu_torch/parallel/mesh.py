"""Device meshes over ``torch.distributed`` (port of
lqrrt_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``jax.sharding.Mesh``; the port
is multi-controller SPMD: one process a device under ``torch.distributed``,
and a ``torch.distributed.device_mesh.DeviceMesh`` whose named dims stand
for the JAX mesh's axis names.  Each rank runs the JAX per-device body
(``parallel/sharded.py``, ``parallel/map_sharded.py``) literally:
``jax.lax.axis_index(axis)`` is the rank's coordinate on that dim
(``axis_index``), and a collective over one axis runs on
``mesh.get_group(axis)``; over a tuple of every dim of the mesh (the
hosts x chips mesh's ``("host", "dp")``) it runs on the group that spans
them, in host-major rank order, as JAX's does.

The tree is a plain tensor tree on each rank, identical on every rank;
there are no DTensors, so JAX's ``replicated`` and ``sharded_leading``,
which only feed ``device_put``, have no counterpart.

Mesh axes, as in the JAX package:
  "dp"       -- the candidate batch sharded over ranks (P1);
  "scenario" -- a fleet's scenarios sharded over ranks (P4);
  "map"      -- occupancy-grid slabs sharded over ranks (P3).

Every mesh spans the whole world: call ``init_distributed`` (or
``torch.distributed.init_process_group``) first; a device count other than
the world size raises.  The backend follows the device type the caller
names, NCCL for "cuda" and gloo for "cpu", with no detection and no
fallback.  The ranks agree on their host-side decisions (the budget, a
kill, the fleet's chunk length) over a gloo group on CPU tensors
(``agree_any``, ``agree_first``), never through a sync on the device.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

_CONTROL = [None, None]    # (the default group it was made for, the group)


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r} "
                         f"(one of {sorted(BACKENDS)})")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but CUDA is not available; "
                           "pass device_type='cpu' for a gloo mesh")
    return BACKENDS[device_type]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device_type: str = "cuda"):
    """Join a ``num_processes``-rank job as rank ``process_id``: NCCL for
    ``device_type="cuda"`` (each rank bound to ``cuda:{local rank}``, the
    ``LOCAL_RANK`` a launcher such as ``torchrun`` sets, else the rank
    modulo the node's device count), gloo for "cpu".  ``coordinator`` is
    ``host:port`` (or any ``init_method`` URL; None reads the ``env://``
    variables).  A no-op for one process or fewer, as JAX's."""
    if num_processes is None or num_processes <= 1:
        return
    backend = _backend(device_type)
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if coordinator is None:
        url = "env://"
    elif "://" in coordinator:
        url = coordinator
    else:
        url = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    control_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _make(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    backend = _backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_distributed (or init_process_group) first")
    if dist.get_backend() != backend:
        raise ValueError(f"a {device_type!r} mesh needs the {backend} "
                         f"backend; the process group runs "
                         f"{dist.get_backend()}")
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    if world_size() > 1:
        control_group()
    return mesh


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device_type: str = "cuda"):
    """1-D mesh over every rank of the world."""
    world = world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the world has {world} "
                         "ranks (a mesh spans the whole world)")
    return _make(device_type, (world,), (axis,))


def make_fleet_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    return make_mesh(n_devices, axis="scenario", device_type=device_type)


def make_mesh_2d(n_hosts: int, chips_per_host: int | None = None,
                 axes: tuple[str, str] = ("host", "dp"),
                 device_type: str = "cuda"):
    """2-D (hosts x chips) mesh: ranks host-major, so each row is one
    host's ranks under a launcher that numbers ranks host by host.  The
    candidate-sharded round shards over both dims with ``axis=axes``."""
    world = world_size()
    if chips_per_host is None:
        if world % n_hosts != 0:
            raise ValueError(f"{world} ranks not divisible by "
                             f"n_hosts={n_hosts}")
        chips_per_host = world // n_hosts
    if n_hosts * chips_per_host != world:
        raise ValueError(f"need {n_hosts * chips_per_host} ranks, the world "
                         f"has {world}")
    return _make(device_type, (n_hosts, chips_per_host), tuple(axes))


def make_mesh_dp_map(n_dp: int, n_map: int | None = None,
                     axes: tuple[str, str] = ("dp", "map"),
                     device_type: str = "cuda"):
    """2-D (dp x map) mesh for the P1 x P3 composed rounds: the candidate
    batch sharded over ``dp``, occupancy-grid slabs over ``map``
    (``parallel/map_sharded.py``; reachable from ``Planner(mesh=...,
    feasibility_grid=...)``).  n_dp=1 is a map-sharded (P3) deployment."""
    world = world_size()
    if n_map is None:
        if world % n_dp != 0:
            raise ValueError(f"{world} ranks not divisible by n_dp={n_dp}")
        n_map = world // n_dp
    if n_dp * n_map != world:
        raise ValueError(f"need {n_dp * n_map} ranks, the world has {world}")
    return _make(device_type, (n_dp, n_map), tuple(axes))


# ---- one axis or a tuple of axes: size, the rank's index, the group ----

def _names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _dim(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the mesh has no {name!r} axis (axes: {names})")
    return names.index(name)


def axis_size(mesh, axis) -> int:
    """Ranks over ``axis``: one dim name, or a tuple of names (the
    product), as JAX's ``mesh_axis_size``."""
    out = 1
    for a in _names(axis):
        out *= mesh.size(_dim(mesh, a))
    return out


def axis_index(mesh, axis) -> int:
    """This rank's coordinate over ``axis`` (``jax.lax.axis_index``): over
    a tuple, the row-major index over its dims."""
    idx = 0
    for a in _names(axis):
        d = _dim(mesh, a)
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def axis_group(mesh, axis):
    """The process group of a collective over ``axis``: one dim's group,
    or, for a tuple of every dim of the mesh in order, the world (the
    mesh is ``arange(world)`` in row-major order, so group ranks run
    host-major, as JAX's)."""
    names = _names(axis)
    dims = [_dim(mesh, a) for a in names]
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    if dims != list(range(mesh.ndim)):
        raise ValueError(f"a tuple axis must name every dim of the mesh in "
                         f"order, {tuple(mesh.mesh_dim_names)}; got {names}")
    if mesh.mesh.flatten().tolist() != list(range(world_size())):
        raise ValueError("the mesh does not span the world in rank order")
    return dist.group.WORLD


def check_device(mesh, device) -> None:
    """Raise unless the mesh's device type is ``device``'s."""
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the "
                         f"planner's device is {torch.device(device)}")


# ---- host decisions: agreed over a gloo group on CPU tensors ----

def control_group():
    """A gloo group over the world for the ranks' host-side agreement: the
    world group itself under gloo, a new gloo group under NCCL (made once
    a world, by every rank at the same point)."""
    default = dist.group.WORLD
    if _CONTROL[0] is not default:
        group = (None if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
        _CONTROL[:] = [default, group]
    return _CONTROL[1]


def agree_any(*flags: bool) -> list:
    """Each flag true on any rank: one MAX all-reduce of a CPU tensor over
    the control group (the flags as given for one rank)."""
    if world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=control_group())
    return [bool(v) for v in t.tolist()]


def agree_first(*values: int) -> list:
    """The first rank's integers on every rank: one broadcast of a CPU
    tensor over the control group."""
    if world_size() == 1:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.broadcast(t, src=0, group=control_group())
    return [int(v) for v in t.tolist()]
