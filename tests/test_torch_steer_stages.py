"""Kernel F's plain versions against the JAX tools (CPU): F1, F2 and F3.

- F1: ``make_steer_kernel_dv`` (``lqrrt_tpu_torch/ops/kernels/
  steer_kernel.py``) on CPU tensors against ``make_steer_pallas_dv``
  (tools/exp_steer_dv_v5.py) in interpret mode, at B = 64, batch_tile 64,
  H = 100 on ``branch_batch``: length, in_goal, reached and the mask equal;
  x_seq and xnew within 1e-3; u_seq within 1e-3 plus |K|'s largest row sum
  times the difference of the state each step starts from (the tolerances
  of tests/test_torch_steer_kernel.py, for the same reasons).
- F2: each of ``steer_stages.build``'s twelve configurations against the
  tool's ``build`` (tools/exp_steer_stages_v5.py) in interpret mode, at
  B = 512, H = 100 on the tool's data distribution (x0 ~ N(0, 1), K ~
  0.1 N(0, 1), xtar ~ 5 N(0, 1), from a numpy seed): length equal; xs and
  us within ATOL = 1e-5 (fp32 over 100 steps of up to an RK4 each, values
  up to ~13: XLA and PyTorch round sin, cos and fused products each in
  their own way; the largest difference seen was 2.9e-6).
  ``identity_nostore`` stores only step 0, so only index 0 is compared.
- F3: ``steer_stages.run_stage``'s six stages against the tool's
  ``run_stage`` (tools/dbg_steer_kernel.py) on its all-ones inputs (B =
  1024): length exact, xs within ATOL.
- The hold of the kernel's full, dbg_feasibility and dbg_full bodies,
  which only store once a step has failed: on the plain scaffold and on
  the tools' scaffolds in interpret mode (``build(s_full)``, and
  ``run_stage`` with ``branch_inputs`` in place of all ones), a failed step
  keeps x, and every later x, u and length equal the held ones.
- The stages' launch geometry (D's ``rollout_geometry``) covers every
  candidate once, from the arguments the wrapper passes to the kernel.
- The device wrap (``wrap_angle_fast`` in csrc/boat_device.cuh: two exact
  subtractions by selects, fmodf past 8 pi) emulated in float32 numpy has
  ``ops/angles.py`` ``wrap_angle``'s bits; the patches of the experiments
  that build other forms of the sources find their text once.

The tools are scripts, not a package (``load_tool``): their source is run
in a fresh module with ``pallas_call`` in interpret mode.  The CUDA kernels
run only on the card (``chip_smoke.py``); on CPU tensors the wrappers take
their plain versions and launch nothing."""
import functools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu_torch.ops.kernels import steer_kernel, steer_stages
from lqrrt_tpu_torch.ops.kernels.steer_kernel import make_steer_kernel_dv
from lqrrt_tpu_torch.ops.kernels.steer_stages import (F2, F3, build, plain,
                                                      run_stage)
from lqrrt_tpu_torch.ops.angles import wrap_angle
from lqrrt_tpu_torch.tools import (dbg_steer_kernel, exp_rollout_circles,
                                   exp_steer_dv, exp_steer_stages,
                                   exp_wrap_forms)
from lqrrt_tpu_torch.tools.exp_steer_kernel import (DT, H, TOL, boat_K,
                                                    branch_batch, steer_args)
from lqrrt_tpu_torch.tools.kernel_times import first_hold
from lqrrt_tpu_torch.models import boat

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
PROB = boat.default_problem()
JPROB = jboat.default_problem()
# F2's configurations -> (the tool's body, its store flag)
TOOL_BODIES = {
    "identity": ("s_identity", True),
    "identity_nostore": ("s_identity", False),
    "erf": ("s_erf", True), "matvec": ("s_matvec", True),
    "saturate": ("s_sat", True), "dynamics": ("s_dyn", True),
    "full": ("s_full", True), "sin_whole": ("s_sin", True),
    "sincos8_row": ("s_sincos8", True), "rk4_lin_rows": ("s_rk4_lin", True),
    "euler_full": ("s_euler_full", True),
    "rk4_trig_rows": ("s_rk4_trig_nostack", True),
}


def _interpret_pallas(recorded):
    """A copy of ``jax.experimental.pallas`` whose ``pallas_call`` runs in
    interpret mode and appends each call's outputs to ``recorded``."""
    from jax.experimental import pallas as pl

    ns = types.ModuleType("pallas_interpret")
    ns.__dict__.update(pl.__dict__)

    def pallas_call(*args, **kw):
        fn = pl.pallas_call(*args, **{**kw, "interpret": True})

        def call(*a):
            out = fn(*a)
            recorded.append(out)
            return out
        return call

    ns.pallas_call = pallas_call
    return ns


def load_tool(name, stop=None, replace=None, namespace=None):
    """tools/<name> as a module: its source up to the first line that
    starts with ``stop`` (the rest benches at import), each line that is a
    key of ``replace`` replaced by its value (a size, an input), without
    its ``from jax.experimental import pallas as pl`` and its ``sys.path``
    and one-line cache set-up lines, run in a fresh module that holds
    ``namespace``'s names and whose ``pl`` is ``_interpret_pallas`` (its
    outputs in ``.recorded``).  A cache call that spans lines is a no-op
    while the source runs, and ``sys.path`` and JAX's config are put back
    afterwards."""
    import lqrrt_tpu.utils.cache as cache

    path = REPO / "tools" / name
    lines = path.read_text().splitlines(keepends=True)
    if stop is not None:
        lines = lines[:next(i for i, line in enumerate(lines)
                            if line.startswith(stop))]
    replace = replace or {}
    lines = [replace[line.rstrip("\n")] + "\n"
             if line.rstrip("\n") in replace else line for line in lines]
    source = "".join(
        line for line in lines
        if line.strip() != "from jax.experimental import pallas as pl"
        and not line.startswith(("sys.path.insert(",
                                 "enable_persistent_cache(\"")))
    mod = types.ModuleType(path.stem)
    mod.__file__ = str(path)
    mod.__dict__.update(namespace or {})
    mod.recorded = []
    mod.pl = _interpret_pallas(mod.recorded)
    saved_path, saved_cfg = list(sys.path), dict(jax.config.values)
    saved_cache = cache.enable_persistent_cache
    cache.enable_persistent_cache = lambda *a, **k: None
    try:
        exec(compile(source, str(path), "exec"), mod.__dict__)
    finally:
        cache.enable_persistent_cache = saved_cache
        sys.path[:] = saved_path
        for k, v in saved_cfg.items():
            if jax.config.values.get(k) != v:
                jax.config.update(k, v)
    return mod


@functools.lru_cache(maxsize=None)
def dv_tool():
    return load_tool("exp_steer_dv_v5.py", stop="H_, n_, m_, B_")


@functools.lru_cache(maxsize=None)
def stages_tool():
    """exp_steer_stages_v5.py at B = Bt = 512; ``s_euler_full`` needs
    ``prob_f``, which the tool defines only under STAGE2."""
    mod = load_tool("exp_steer_stages_v5.py")
    mod.B = mod.Bt = 512
    mod.prob_f = jboat.f
    return mod


@functools.lru_cache(maxsize=None)
def dbg_tool():
    """dbg_steer_kernel.py, which runs its six stages when loaded."""
    return load_tool("dbg_steer_kernel.py")


HOLD_B = 512   # the batch of the hold tests (the stages tool's B)


@functools.lru_cache(maxsize=None)
def dbg_tool_branches():
    """dbg_steer_kernel.py at B = Bt = HOLD_B with its six stages run on
    ``dbg_steer_kernel.branch_inputs`` (seed 0) in place of all ones."""
    ins = dbg_steer_kernel.branch_inputs(HOLD_B, 0, "cpu")
    return load_tool("dbg_steer_kernel.py", replace={
        "H, n, m, B, Bt = 100, 6, 3, 1024, 256":
            f"H, n, m, B, Bt = 100, 6, 3, {HOLD_B}, {HOLD_B}",
        "        )(jnp.ones((n, B)), jnp.ones((m, n, B)), jnp.ones((n, B)), "
        "*const_in)": "        )(*INPUTS, *const_in)"},
        namespace={"INPUTS": [jnp.asarray(a.numpy()) for a in ins]})


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_tools_load_without_editing():
    """Every F tool loads by the loader, and each pallas_call it made ran
    in interpret mode with the shapes of the port's outputs."""
    assert callable(dv_tool().make_steer_pallas_dv)
    assert callable(stages_tool().build) and stages_tool().B == 512
    rec = dbg_tool().recorded
    assert len(rec) == len(F3)
    for xs, length in rec:
        assert xs.shape == (H, 6, 1024) and length.shape == (1024,)
        assert length.dtype == jnp.int32


def test_dv_wrapper_matches_pallas_dv_interpret():
    """F1 on CPU tensors against make_steer_pallas_dv in interpret mode
    (B = 64, batch_tile 64, H = 100, the goal box, scalar tol)."""
    B = 64
    x0, xtar, _ = branch_batch(B, 0, PROB)
    K = np.broadcast_to(boat_K(PROB), (B, 3, 6)).copy()
    goal = PROB["goal"]
    args, kw = steer_args(PROB)
    launches = dict(steer_kernel.LAUNCHES)
    port = make_steer_kernel_dv(*args, batch_tile=64, **kw)(
        *_t(x0, K, xtar, goal))
    assert steer_kernel.LAUNCHES == launches      # the CPU launches nothing
    jres = dv_tool().make_steer_pallas_dv(
        JPROB["dynamics"], JPROB["erf"], JPROB["constraints"].is_feasible,
        H, DT, TOL, saturate=JPROB["saturate"],
        goal_buffer=JPROB["constraints"].goal_buffer, batch_tile=64,
        interpret=True)(jnp.asarray(x0), jnp.asarray(K), jnp.asarray(xtar),
                        jnp.asarray(goal))
    for field in ("length", "in_goal", "reached", "mask"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(jres, field)),
                                      err_msg=field)
    for field in ("x_seq", "xnew"):
        np.testing.assert_allclose(getattr(port, field).numpy(),
                                   np.asarray(getattr(jres, field)),
                                   rtol=0, atol=1e-3, err_msg=field)
    start_p = np.concatenate([x0.T[None], port.x_seq.numpy()[:-1]])
    start_j = np.concatenate([x0.T[None], np.asarray(jres.x_seq)[:-1]])
    dx = np.abs(start_p - start_j).max(axis=1, keepdims=True)
    du = np.abs(port.u_seq.numpy() - np.asarray(jres.u_seq))
    assert (du <= 1e-3 + np.abs(K).sum(-1).max() * dx).all(), du.max()


def _stage_data(B, seed=0):
    """The tool's bench distribution, from a numpy seed."""
    return [a.numpy() for a in exp_steer_stages.stage_inputs(B, seed, "cpu")]


@pytest.mark.parametrize("stage", F2)
def test_stage_matches_tool_build_interpret(stage):
    """One of F2's configurations against the tool's build (B = 512)."""
    x0T, KT, tarT = _stage_data(512)
    body, store = TOOL_BODIES[stage]
    st = stages_tool()
    jxs, jus, jlen = map(np.asarray, st.build(getattr(st, body), store=store)(
        jnp.asarray(x0T), jnp.asarray(KT), jnp.asarray(tarT)))
    xs, us, length = build(stage)(*_t(x0T, KT, tarT))
    np.testing.assert_array_equal(length.numpy(), jlen)
    keep = slice(None) if store else slice(0, 1)
    np.testing.assert_allclose(xs.numpy()[keep], jxs[keep], rtol=0, atol=ATOL)
    np.testing.assert_allclose(us.numpy()[keep], jus[keep], rtol=0, atol=ATOL)
    assert np.isfinite(jxs[keep]).all() and np.isfinite(jus[keep]).all()


@pytest.mark.parametrize("i,stage", list(enumerate(F3)))
def test_dbg_stage_matches_tool_run_stage_interpret(i, stage):
    """One of F3's stages against the tool's run_stage on all ones."""
    jxs, jlen = map(np.asarray, dbg_tool().recorded[i])
    ones = [torch.ones(s) for s in ((6, 1024), (3, 6, 1024), (6, 1024))]
    xs, length = run_stage(stage)(*ones)
    np.testing.assert_array_equal(length.numpy(), jlen)
    np.testing.assert_allclose(xs.numpy(), jxs, rtol=0, atol=ATOL)


def _branch_body_data(seed=0, k=64):
    """(x (6, 4k), K (3, 6, 4k), tar (6, 4k)) in four groups of k columns,
    so that one step of F3's full body takes each branch: the tool's
    distribution (x ~ N(0, 1), K ~ 0.1 N(0, 1), tar ~ 5 N(0, 1)); x at
    rest inside the goal box (hit); tar 0.01 from x (arrived); x at rest
    inside the first buoy (infeasible)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 4 * k))
    K = rng.standard_normal((3, 6, 4 * k)) * 0.1
    tar = rng.standard_normal((6, 4 * k)) * 5.0
    goal = PROB["goal"].astype(np.float64)
    g = slice(k, 2 * k)
    x[:, g] = goal[:, None]
    x[:2, g] += rng.uniform(-0.5, 0.5, (2, k))
    x[2, g] += rng.uniform(-0.1, 0.1, k)
    a = slice(2 * k, 3 * k)
    d = rng.standard_normal((6, k))
    tar[:, a] = x[:, a] + 0.01 * d / np.linalg.norm(d, axis=0)
    o = slice(3 * k, 4 * k)
    (cx, cy) = PROB["obstacles"][0][0]
    x[:, o] = 0.0
    x[0, o] = cx + rng.uniform(-0.3, 0.3, k)
    x[1, o] = cy + rng.uniform(-0.3, 0.3, k)
    return [a.astype(np.float32) for a in (x, K, tar)]


@pytest.mark.parametrize("stage,tool_body", [("dbg_matvec", "s3"),
                                             ("dbg_feasibility", "s5"),
                                             ("dbg_full", "s6")])
def test_dbg_body_matches_tool_on_every_branch(stage, tool_body):
    """F3's matvec, feasibility and full bodies against the tool's s3, s5
    and s6 (tools/dbg_steer_kernel.py) for one step on data that is not
    all ones (``_branch_body_data``): the 3-row sum, the circles and the
    goal box take part.  x_out within ATOL relative to |x| (one step of
    up to an RK4 on values up to 40), the count exact; the tool's full
    body rejects the goal-box, arrived and buoy groups and takes most of
    the first group."""
    x, K, tar = _branch_body_data()
    jout = getattr(dbg_tool(), tool_body)(*map(jnp.asarray, (x, K, tar)))
    out = steer_stages.STAGES[stage].body(*_t(x, K, tar))
    if stage == "dbg_matvec":
        jout, out = (jout, None), (out, None)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=ATOL, atol=ATOL)
    assert np.abs(out[0].numpy() - x).max() > 1e-3     # not the identity
    if stage == "dbg_matvec":
        return
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    inc = np.asarray(jout[1]).reshape(4, -1)
    if stage == "dbg_full":
        assert (inc[1:] == 0).all()
    else:
        assert (inc[3] == 0).all() and (inc[1:3] == 1).all()
    assert inc[0].mean() > 0.5


def test_plain_scaffold_stores_and_counts():
    """The scaffold around a body: identity_nostore writes x_H to xs[0]
    and zeros to us[0]; F2 counts every step, F3's full only the steps
    whose select took the new state (none from rest at the target)."""
    x0T, KT, tarT = _t(*_stage_data(8, seed=1))
    xs, us, length = plain("identity_nostore", x0T, KT, tarT)
    assert torch.equal(xs[0], plain("identity", x0T, KT, tarT)[0][-1])
    assert torch.equal(us[0], torch.zeros_like(us[0]))
    assert torch.equal(plain("full", x0T, KT, tarT)[2],
                       torch.full((1, 8), H, dtype=torch.int32))
    ones = [torch.ones(s) for s in ((6, 8), (3, 6, 8), (6, 8))]
    assert torch.equal(plain("dbg_full", *ones)[2],
                       torch.zeros(8, dtype=torch.int32))


def test_stage_wrappers_launch_nothing_on_cpu():
    x0T, KT, tarT = _t(*_stage_data(8))
    launches = dict(steer_stages.LAUNCHES)
    for stage in F2:
        build(stage)(x0T, KT, tarT)
    for stage in F3:
        run_stage(stage)(x0T, KT, tarT)
    assert steer_stages.LAUNCHES == launches


@pytest.mark.parametrize("bad", ["unknown", "f3-name-in-build",
                                 "f2-name-in-run-stage", "int32",
                                 "k-shape", "batch-mismatch", "float64",
                                 "shape", "non-contiguous", "dv-batch-tile",
                                 "dv-no-goal", "dv-float64"])
def test_wrappers_check_their_inputs(bad):
    x0T, KT, tarT = _t(*_stage_data(8))
    args, kw = steer_args(PROB)
    x0, K, xtar = x0T.T.contiguous(), KT.permute(2, 0, 1).contiguous(), \
        tarT.T.contiguous()
    goal = torch.from_numpy(PROB["goal"])
    with pytest.raises((TypeError, ValueError)):
        if bad == "unknown":
            build("rk4")
        elif bad == "f3-name-in-build":
            build("dbg_full")
        elif bad == "f2-name-in-run-stage":
            run_stage("full")
        elif bad == "int32":
            run_stage("dbg_full")(x0T.int(), KT, tarT)
        elif bad == "k-shape":
            build("full")(x0T, KT[:, :5].contiguous(), tarT)
        elif bad == "batch-mismatch":
            build("matvec")(x0T, KT, tarT[:, :4].contiguous())
        elif bad == "float64":
            build("full")(x0T.double(), KT, tarT)
        elif bad == "shape":
            build("full")(x0T[:5], KT, tarT)
        elif bad == "non-contiguous":
            run_stage("dbg_erf")(x0T, KT.transpose(0, 1).contiguous()
                                 .transpose(0, 1), tarT)
        elif bad == "dv-batch-tile":
            make_steer_kernel_dv(*args, batch_tile=48, **kw)
        elif bad == "dv-no-goal":
            make_steer_kernel_dv(*args, **kw)(x0, K, xtar)
        else:
            make_steer_kernel_dv(*args, **kw)(x0.double(), K, xtar, goal)


def test_entry_points_main_on_cpu(monkeypatch, capsys):
    """The three entry points end to end at a small size on the CPU, where
    every wrapper takes its plain version; each refuses the card when
    there is none."""
    monkeypatch.setattr(exp_steer_dv, "REPS", 1)
    monkeypatch.setattr(exp_steer_stages, "REPS", 1)
    out = exp_steer_dv.main(device="cpu", B=32)
    assert sorted(out["kernel"]) == sorted(exp_steer_dv.BATCH_TILES)
    for c in out["kernel"].values():
        assert c["len_eq"] == 1.0 and c["max_dx"] == 0.0 and c["ms"] > 0
    out = exp_steer_stages.main(device="cpu", B=32)
    assert list(out["stages"]) == list(F2)
    assert all(v["ms"] > 0 for v in out["stages"].values())
    assert out["steer_rollout_ms"] > 0
    assert dbg_steer_kernel.main(device="cpu", B=16) == 0
    printed = capsys.readouterr().out
    assert printed.count(": OK") == len(F3) and "FAILED" not in printed
    for main in (exp_steer_dv.main, exp_steer_stages.main,
                 dbg_steer_kernel.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(device="cuda")


@pytest.mark.parametrize("stage", ["full", "dbg_feasibility", "dbg_full"])
@pytest.mark.parametrize("who", ["plain", "tool"])
def test_failed_step_holds(stage, who):
    """Once a step of full, dbg_feasibility or dbg_full fails (the select
    keeps x), every later step repeats it: x, u and the length stay the
    held ones, which the kernel then only stores (``kernel_times.
    first_hold`` finds the failed step).  On the port's plain
    scaffold and on the tool's scaffold in interpret mode (F2's
    ``build(s_full)``; F3's ``run_stage`` on ``branch_inputs``, whose
    lengths the port's equal), at B = HOLD_B on ``branch_inputs``, where
    the goal-box, buoy and near groups fail at their first steps or
    later, and others never."""
    ins = dbg_steer_kernel.branch_inputs(HOLD_B, 0, "cpu")
    f2 = steer_stages.STAGES[stage].tool == "F2"
    if who == "plain":
        xs, us, length = plain(stage, *ins)
        xs, length = xs.numpy(), length.numpy()
        us = None if us is None else us.numpy()
    elif f2:
        st = stages_tool()
        xs, us, length = map(np.asarray, st.build(st.s_full)(
            *[jnp.asarray(a.numpy()) for a in ins]))
    else:
        xs, length = map(np.asarray, dbg_tool_branches().recorded[
            F3.index(stage)])
        us = None
        # and the port's lengths on the same data
        np.testing.assert_array_equal(plain(stage, *ins)[2].numpy(), length)
    assert xs.shape == (H, 6, HOLD_B)
    h0 = first_hold(ins[0], torch.from_numpy(xs)).numpy()
    held = h0 < H
    assert held.sum() >= 8 and (h0[held] > 0).any() and (~held).any()
    for h in range(H):
        later = h0 <= h
        np.testing.assert_array_equal(xs[h][:, later],
                                      xs[h0[later], :, np.nonzero(later)[0]].T)
        if us is not None:
            np.testing.assert_array_equal(
                us[h][:, later], us[h0[later], :, np.nonzero(later)[0]].T)
    np.testing.assert_array_equal(length.reshape(-1),
                                  np.full(HOLD_B, H) if f2 else h0)


@pytest.mark.parametrize("B", [1, 31, 1024, 1027, 8191, 8192])
def test_stage_geometry_covers_every_candidate_once(B, monkeypatch):
    """The threads and blocks the wrapper passes to ``lqrrt_steer_stage``
    (D's ``rollout_geometry``) on cards of 132, 114 and 16 SMs: a multiple
    of 32 in [32, 128] threads a block, and thread t of the grid takes
    candidate t, so every candidate is taken once and no block is idle."""
    calls = []
    monkeypatch.setattr(steer_stages, "_launch",
                        lambda fn, *args: calls.append(args))
    monkeypatch.setattr(steer_stages, "LAUNCHES",
                        dict(steer_stages.LAUNCHES))
    x0T, KT, tarT = (torch.zeros(s) for s in ((6, B), (3, 6, B), (6, B)))
    for sms in (132, 114, 16):
        monkeypatch.setattr(steer_stages, "sm_count", lambda dev: sms)
        for stage in ("full", "dbg_full"):
            steer_stages._launch_stage(stage, x0T, KT, tarT)
            threads, blocks = calls[-1][-2:]
            assert 32 <= threads <= 128 and threads % 32 == 0
            taken = np.arange(blocks * threads)
            taken = taken[taken < B]
            assert (np.bincount(taken, minlength=B) == 1).all()
            assert (blocks - 1) * threads < B


def test_wrap_selects_have_wrap_angle_bits():
    """``wrap_angle_fast``'s two selects, one float32 rounding an
    operation as on the card, give ``wrap_angle``'s bits on 1e6 uniform
    angles in [-60, 60] (the selects below 8 pi, fmodf past it) and at
    every multiple of 2 pi minus pi from -9 to 9 and its two neighbours,
    where a subtraction leaves zero; NaN for NaN and inf."""
    f = np.float32
    pi = f(np.pi)
    two_pi = f(2) * pi
    four_pi = f(2) * two_pi
    edges = [v for k in range(-9, 10) for v in (
        f(k) * two_pi - pi, np.nextafter(f(k) * two_pi - pi, f(np.inf)),
        np.nextafter(f(k) * two_pi - pi, f(-np.inf)))]
    a = np.concatenate([
        np.random.default_rng(0).uniform(-60, 60, 10 ** 6).astype(f),
        np.array(edges + [np.nan, np.inf, -np.inf, 0.0, -0.0], f)])
    with np.errstate(invalid="ignore"):
        s = a + pi
        r = np.where(np.abs(s) >= four_pi, s - np.copysign(four_pi, s), s)
        r = np.where(np.abs(r) >= two_pi, r - np.copysign(two_pi, r), r)
        past = ~(np.abs(s) < f(2) * four_pi)
        r = np.where(past, np.fmod(s, two_pi), r)
        out = np.where(r < 0, r + two_pi, r) - pi
    ref = wrap_angle(torch.from_numpy(a)).numpy()
    assert out.dtype == ref.dtype == np.float32
    assert 0 < past.sum() < a.size - 5
    np.testing.assert_array_equal(out.view(np.int32)[~np.isnan(ref)],
                                  ref.view(np.int32)[~np.isnan(ref)])
    assert np.array_equal(np.isnan(out), np.isnan(ref))


def test_experiment_patches_find_their_text():
    """The source patches of the experiments that build other forms of
    csrc/ (``exp_rollout_circles.OTHER`` on steer_rollout.cu, each of
    ``exp_wrap_forms.FORMS`` on boat_device.cuh) are found exactly once in
    the committed sources, so those builds differ only where they mean
    to."""
    csrc = REPO / "lqrrt_tpu_torch" / "csrc"
    rollout = (csrc / "steer_rollout.cu").read_text()
    for old, _ in exp_rollout_circles.OTHER:
        assert rollout.count(old) == 1, old
    assert (csrc / "boat_device.cuh").read_text().count(
        exp_wrap_forms.SELECTS) == 1
    assert set(exp_wrap_forms.FORMS) >= set(exp_wrap_forms.TURNS)
