"""The port's obstacle models against the JAX package's on the same numpy
inputs (CPU): ``state_box``, ``OccupancyGrid``, ``circles_free_data``,
``grid_free_data`` and the grid boat's raster.  Each predicate returns a
boolean, so agreement is exact (no tolerance), except at a NaN position:
there the port reads occupied and the JAX functions read free, which each
NaN test shows on both sides."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.ops import collision as jcollision
from lqrrt_tpu_torch.models import boat
from lqrrt_tpu_torch.ops import collision

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_batch(pred, x, *args):
    """A JAX predicate of one (x, u) vmapped over x's rows."""
    return np.asarray(jax.vmap(lambda xi: pred(xi, None, *args))(
        jnp.asarray(x)))


def test_state_box_matches():
    rng = np.random.default_rng(3)
    x = rng.uniform(-2.0, 12.0, (512, 4)).astype(np.float32)
    x[:2, 0] = [0.0, 10.0]                        # the box is closed
    for lo, hi, dims in (([0.0], [10.0], [0]), ([-1.0, 0.0], [1.0, 5.0],
                                                [2, 1]),
                         ([0.0] * 4, [10.0] * 4, None)):
        jp = jcollision.state_box(lo, hi, dims=dims)
        want = _jax_batch(jp, x)
        assert 0 < want.sum() < len(want)
        got = collision.state_box(lo, hi, dims=dims)(_t(x), None).numpy()
        np.testing.assert_array_equal(got, want)


def _grids():
    occ = np.zeros((10, 10), np.uint8)
    occ[4:6, 7:9] = 1                             # rows y=4..5, cols x=7..8
    return (jcollision.OccupancyGrid(occ, (0.0, 0.0), 1.0),
            collision.OccupancyGrid(occ, (0.0, 0.0), 1.0))


def test_occupancy_grid():
    """tests/test_collision.py::test_occupancy_grid on the port."""
    _, grid = _grids()
    assert bool(grid.occupied(_t([7.5, 4.5])))
    assert not bool(grid.occupied(_t([2.0, 2.0])))
    assert bool(grid.occupied(_t([-1.0, 5.0])))
    assert bool(grid.occupied(_t([5.0, 99.0])))
    feas = grid.feasibility(footprint_radius=1.0)
    assert not bool(feas(_t([6.5, 4.5]), None))   # ring touches block
    assert bool(feas(_t([3.0, 2.0]), None))
    pts = _t([[7.5, 4.5], [2.0, 2.0], [-1.0, 0.0]])
    np.testing.assert_array_equal(grid.occupied(pts).numpy(),
                                  [True, False, True])


def test_occupancy_grid_matches_on_seeded_points():
    """4096 seeded points over and around the grid, cell edges and huge
    coordinates: occupied, is_feasible and the footprint predicate equal
    the JAX ones point for point; out of bounds is occupied."""
    jgrid, grid = _grids()
    rng = np.random.default_rng(7)
    p = rng.uniform(-3.0, 13.0, (4096, 2)).astype(np.float32)
    p[:64] = np.floor(p[:64])                     # exact cell edges
    p[64:72] = [[0, 0], [10, 0], [0, 10], [9.999, 9.999], [-1e-6, 5],
                [3e9, 5], [5, -3e9], [1e30, 1e30]]
    want = np.asarray(jgrid.occupied(jnp.asarray(p)))
    got = grid.occupied(_t(p)).numpy()
    np.testing.assert_array_equal(got, want)
    oob = (p < 0).any(1) | (p >= 10).any(1)
    assert got[oob].all() and oob.sum() > 1000 and (~got).sum() > 1000
    x = np.concatenate([p, rng.normal(size=(4096, 2))], 1).astype(np.float32)
    for r in (0.0, 0.7):
        jf, tf = jgrid.feasibility(r), grid.feasibility(r)
        np.testing.assert_array_equal(tf(_t(x), None).numpy(),
                                      _jax_batch(jf, x))


def test_grid_nan_is_occupied_where_jax_reads_free():
    """The port fixes a reference quirk: JAX casts floor(NaN) to cell 0
    before its bounds test, so a NaN position reads cell (0, 0), free here;
    the port tests the bounds on the float cell, so NaN is out of bounds,
    hence occupied."""
    jgrid, grid = _grids()
    p = np.array([[np.nan, 2.0], [2.0, np.nan], [np.nan, np.nan]],
                 np.float32)
    assert not np.asarray(jgrid.occupied(jnp.asarray(p))).any()   # JAX
    assert grid.occupied(_t(p)).all()                             # port
    jfree = jcollision.grid_free_data((0.0, 0.0), 1.0)
    tfree = collision.grid_free_data((0.0, 0.0), 1.0)
    occ = np.asarray(jgrid.occ, np.uint8)
    assert _jax_batch(jfree, p, jnp.asarray(occ)).all()            # free
    assert not tfree(_t(p), None, torch.from_numpy(occ)).any()


def test_circles_free_data_matches():
    """Radius < 0 pads inactive slots; the margin inflates the rest."""
    rng = np.random.default_rng(5)
    data = {"centers": rng.uniform(-5, 5, (6, 2)).astype(np.float32),
            "radii": np.array([1.0, 0.5, -1.0, 2.0, -0.5, 0.8], np.float32)}
    x = rng.uniform(-6, 6, (4096, 4)).astype(np.float32)
    x[0, :2] = data["centers"][2]                 # inside an inactive slot
    x[1, :2] = data["centers"][0] + [1.05, 0.0]   # inside the margin only
    for m in (0.0, 0.1):
        jp = jcollision.circles_free_data(margin=m)
        tp = collision.circles_free_data(margin=m)
        want = _jax_batch(jp, x, {k: jnp.asarray(v) for k, v in data.items()})
        got = tp(_t(x), None, {k: torch.from_numpy(v)
                               for k, v in data.items()}).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < len(want) and want[0]
        assert want[1] == (m == 0.0)
    # all slots inactive: everything is free
    off = {"centers": torch.from_numpy(data["centers"]),
           "radii": -torch.ones(6)}
    assert collision.circles_free_data()(_t(x), None, off).all()


def test_circles_free_data_nan_is_a_hit_where_jax_reads_free():
    """The port fixes a reference quirk: JAX tests d2 <= r2, false for a
    NaN position, so NaN reads free; the port counts a NaN distance to an
    active circle as a hit, as ``circles_free`` does (d2 > r2 fails)."""
    data = {"centers": np.array([[50.0, 50.0]], np.float32),
            "radii": np.array([1.0], np.float32)}
    x = np.array([[np.nan, 0.0, 0.0, 0.0]], np.float32)
    assert _jax_batch(jcollision.circles_free_data(), x,
                      {k: jnp.asarray(v) for k, v in data.items()}).all()
    got = collision.circles_free_data()(
        _t(x), None, {k: torch.from_numpy(v) for k, v in data.items()})
    assert not got.any()
    assert not collision.circles_free(data["centers"], data["radii"])(
        _t(x), None).any()


def test_grid_free_data_matches():
    rng = np.random.default_rng(9)
    occ = (rng.uniform(size=(12, 20)) < 0.3).astype(np.uint8)
    origin, res = (-2.0, -1.0), 0.5
    x = rng.uniform(-3.0, 9.0, (4096, 3)).astype(np.float32)
    jp = jcollision.grid_free_data(origin, res, pos_dims=(0, 2))
    tp = collision.grid_free_data(origin, res, pos_dims=(0, 2))
    for o in (occ, occ.astype(bool), 1 - occ):    # refreshed grids
        want = _jax_batch(jp, x, jnp.asarray(o))
        got = tp(_t(x), None, torch.from_numpy(o)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < len(want)


def _cell_centres(grid):
    H, W = grid.occ.shape
    cx = grid.origin[0] + (np.arange(W) + 0.5) * grid.resolution
    cy = grid.origin[1] + (np.arange(H) + 0.5) * grid.resolution
    X, Y = np.meshgrid(cx, cy)
    x = np.zeros((H * W, 6), np.float32)
    x[:, 0], x[:, 1] = X.reshape(-1), Y.reshape(-1)
    return x


@pytest.mark.parametrize("resolution", [0.25, 0.5])
def test_grid_boat_raster_bit_equal(resolution):
    """boat.default_problem(obstacle_model="grid"): 96 x 200 cells at 0.25
    m (1.0 m margin), the same cells occupied as in the JAX model, read
    through both problems' predicates at every cell centre and off-grid."""
    jprob = jboat.default_problem(obstacle_model="grid",
                                  grid_resolution=resolution)
    tprob = boat.default_problem(obstacle_model="grid",
                                 grid_resolution=resolution)
    centers, radii = tprob["obstacles"]
    grid = boat.buoy_grid(centers, radii, resolution)
    if resolution == 0.25:
        assert grid.occ.shape == (96, 200)
    x = _cell_centres(grid)
    want = np.asarray(jax.vmap(jprob["constraints"].is_feasible)(
        jnp.asarray(x), jnp.zeros((len(x), 3))))
    np.testing.assert_array_equal(~grid.occ.reshape(-1), want)
    got = tprob["constraints"].is_feasible(_t(x), torch.zeros(len(x), 3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < 1 - want.mean() < 0.5           # the buoys are there
    rng = np.random.default_rng(1)
    xs = rng.uniform([-6, -14, -4, -1, -1, -1], [48, 14, 4, 3, 1, 1],
                     (4096, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tprob["constraints"].is_feasible(_t(xs), torch.zeros(4096, 3))
        .numpy(),
        np.asarray(jax.vmap(jprob["constraints"].is_feasible)(
            jnp.asarray(xs), jnp.zeros((4096, 3)))))


def test_grid_lives_on_the_callers_device():
    """The grid is copied once per device and dtype, on the first call
    there (``Const``), never per call."""
    _, grid = _grids()
    grid.occupied(_t([[1.0, 1.0]]))
    first = grid._occ_flat.like(torch.zeros(1), torch.bool)
    grid.occupied(_t([[2.0, 2.0]]))
    assert grid._occ_flat.like(torch.zeros(1), torch.bool) is first
    assert first.device.type == "cpu" and first.dtype == torch.bool
