"""The per-node LQR's spans and counter (``ops/riccati.py``
``make_relinearized_lqr``, ``utils/timing.py`` ``spanned``) in the
planner's replans on the CPU, and the benchmark's readers of them and of
kernel C and the batched CARE on synthetic runs: ``lqr.linearize`` and
``lqr.care`` under ``round.endpoint`` in the rounds and under the
enclosing span elsewhere, ``lqr.rows`` the states solved, nothing of it on
a constant lqr (the boat)."""
import numpy as np
import pytest
import torch

from lqrrt_tpu_torch import Planner
from lqrrt_tpu_torch.models import boat, car
from lqrrt_tpu_torch.ops.riccati import make_constant_lqr
from lqrrt_tpu_torch.utils.timing import NO_SPANS, PhaseTimer, spanned
from portbench import cells, counts, devtrace, peaks
from portbench.loops import RunData

torch.set_num_threads(2)

LQR_SPANS = ("lqr.linearize", "lqr.care")
BATCH = 64


def _chunk_clock(n_chunks):
    """A clock that reads 0 for t0 and ``n_chunks`` budget checks."""
    calls = [0]

    def clock():
        calls[0] += 1
        return 0.0 if calls[0] <= n_chunks + 1 else 1e9
    return clock


def _replan(mod, mode="restart", finish=False):
    prob = mod.default_problem()
    kw = (dict(rounds_per_chunk=16) if mode == "restart"
          else dict(refine=False, rounds_per_chunk=2))
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=1.0, dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=BATCH,
                capacity=512, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cpu", seed=0, **kw)
    p.sys_time = (_chunk_clock(2) if mode == "restart" else (lambda: 0.0))
    reached = p.update_plan(prob["x0"], prob["sample_space"],
                            goal_bias=0.3, specific_time=1.0,
                            finish_on_goal=finish)
    return p, reached


@pytest.fixture(scope="module")
def car_restart():
    return _replan(car)[0].stats


def test_car_lqr_spans_nest_under_the_rounds_endpoint(car_restart):
    st = car_restart
    spans = st["spans"]
    for name in LQR_SPANS:
        s = spans[name]
        # every round's endpoint, and the two trees' seeds
        assert s["parent"] == "round.endpoint", s
        assert s["parents"] == {"round.endpoint": st["rounds"],
                                "planner.update_plan": 2}, s
        assert s["count"] == st["rounds"] + 2
        assert 0 < s["self_s"] == s["total_s"]
    ep = spans["round.endpoint"]
    inner = sum(spans[n]["total_s"] for n in LQR_SPANS)
    # the endpoint's children are the rounds' share of the lqr spans
    assert 0 < ep["total_s"] - ep["self_s"] <= inner + 1e-9


def test_lqr_rows_count_the_states_solved(car_restart):
    st = car_restart
    assert st["tallies"]["lqr.rows"] == st["rounds"] * BATCH + 2


def test_host_loop_and_finish_carry_the_spans():
    p, reached = _replan(car, mode="host", finish=True)
    st = p.stats
    spans = st["spans"]
    extra = 1 + (1 if reached else 0)       # the seed, the finish's goal
    for name in LQR_SPANS:
        assert spans[name]["parents"].get("round.endpoint") == st["rounds"]
        assert spans[name]["count"] == st["rounds"] + extra
        if reached:
            assert spans[name]["parents"]["planner.finish"] == 1
    assert st["tallies"]["lqr.rows"] == st["rounds"] * BATCH + extra


def test_a_constant_lqr_records_nothing():
    st = _replan(boat)[0].stats
    assert not [n for n in st["spans"] if n.startswith("lqr.")]
    assert "lqr.rows" not in st["tallies"]
    sp = PhaseTimer()
    const = boat.default_problem()["lqr"]
    assert spanned(const, sp) is const
    A, B = np.zeros((2, 2), np.float32), np.eye(2, dtype=np.float32)
    lti = make_constant_lqr(A, B, np.eye(2), np.eye(2))
    assert spanned(lti, sp) is lti
    relin = car.make_lqr()
    assert spanned(relin, NO_SPANS) is relin
    assert spanned(relin, sp) is not relin


def test_spanned_lqr_keeps_the_contract_and_counts_rows():
    """The spanned lqr returns what the lqr returns, for one state and a
    batch; it tallies the rows from the shapes."""
    sp = PhaseTimer()
    lqr = car.make_lqr()
    timed = spanned(lqr, sp)
    x = torch.tensor([[1.0, 2.0, 0.3, 1.5], [0.0, -1.0, -2.0, 0.2],
                      [3.0, 0.5, 1.0, 4.0]])
    for xs in (x, x[0]):
        u = torch.zeros(xs.shape[:-1] + (2,))
        for a, b in zip(timed(xs, u), lqr(xs, u)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sp.tallies() == {"lqr.rows": 4}
    s = sp.span_summary()
    assert s["lqr.care"]["count"] == s["lqr.linearize"]["count"] == 2
    assert s["lqr.care"]["parent"] is None and s["lqr.care"]["parents"] == {}
    sp.reset()
    assert sp.tallies() == {} and sp.span_summary() == {}


def test_parent_is_the_most_frequent():
    sp = PhaseTimer()
    with sp.span("a"):
        with sp.span("leaf"):
            pass
    for _ in range(2):
        with sp.span("b"):
            with sp.span("leaf"):
                pass
    with sp.span("leaf"):
        pass
    leaf = sp.span_summary()["leaf"]
    assert leaf["parent"] == "b" and leaf["parents"] == {"a": 1, "b": 2}
    sp.tally("t", 5)
    sp.tally("t")
    assert sp.tallies() == {"t": 6}


# ------------------------------------------------------------- the readers

def _car_run(with_spans=True, with_tally=True, trace=True):
    cfg, mix = cells.config("car_bicycle"), cells.traffic("replan_1s")
    spans = {"lqr.linearize": dict(total_s=0.05), "lqr.care": dict(
        total_s=0.07)}
    stats = [dict(expansions=8 * 8192, rounds=8,
                  spans=spans if with_spans else {}, tallies={}),
             dict(expansions=16 * 8192, rounds=16,
                  spans=spans if with_spans else {}, tallies={})]
    run = RunData(cfg, mix, "planner", window_s=2.0,
                  replans=[dict(stats=s, plans=[]) for s in stats])
    rows = 16 * 8192 + 2
    run.traced = [dict(stats=dict(rounds=16, tallies=(
        {"lqr.rows": rows} if with_tally else {})))]
    if trace:
        run.trace = devtrace.Trace(
            window_s=0.5, busy_s=0.05, rounds=16, n_kernels=9000,
            kernels={"void (anonymous namespace)::nn_general_kernel<4, "
                     "true>(...)": [16, 0.0016],
                     "void getrf_semiwarp<float, float, 3, 1, true>(...)":
                     [256, 0.002],
                     "void batch_trsm_left_kernel<float, 64>(...)":
                     [288, 0.003],
                     "void laswp_kernel<float, false>(...)": [342, 0.001],
                     "void trsm_batch_left_upper_kernel<float>(...)":
                     [54, 0.0004],
                     "elementwise": [8000, 0.04]})
    return run


def _read(name, run):
    return cells.reader(name)(run)


def test_host_lqr_ms_per_round():
    assert _read("host.lqr_ms_per_round", _car_run()) == pytest.approx(
        1e3 * 2 * 0.12 / 24)
    assert _read("host.lqr_ms_per_round", _car_run(with_spans=False)) \
        is None


def test_kernel_care_ms_per_round():
    assert _read("kernel.care_ms_per_round", _car_run()) == pytest.approx(
        1e3 * (0.002 + 0.003 + 0.001 + 0.0004) / 16)
    assert _read("kernel.care_ms_per_round", _car_run(trace=False)) is None
    run = _car_run()
    run.trace.kernels = {"elementwise": [10, 0.1]}
    assert _read("kernel.care_ms_per_round", run) is None


def test_kernel_nn_general_ms_and_roofline():
    run = _car_run()
    assert _read("kernel.nn_general_ms_per_round", run) == pytest.approx(
        1e3 * 0.0016 / 16)
    sizes = peaks.restart_tree_sizes(8192, 32768)
    assert sizes == [512, 8704, 16896, 25088]
    pair = counts.nn_general_pair_flops(4, True)
    assert pair == 31
    want = 100 * 16 * 8192 * pair * np.mean(sizes) / (67e12 * 0.0016)
    assert _read("kernel.nn_general_roofline", run) == pytest.approx(want)
    run.trace.kernels = {"elementwise": [10, 0.1]}
    assert _read("kernel.nn_general_ms_per_round", run) is None
    assert _read("kernel.nn_general_roofline", run) is None
    assert _read("kernel.nn_general_roofline", _car_run(trace=False)) is None


def test_step_mfu_car():
    run = _car_run()
    assert counts.care_row_flops(4, 2) == 25624
    per_round = 8192 * (80 * 122 + 31 * np.mean(
        peaks.restart_tree_sizes(8192, 32768)))
    flops = per_round * 16 + 25624 * (16 * 8192 + 2)
    assert _read("step_mfu.car", run) == pytest.approx(
        100 * flops / 0.5 / 67e12)
    assert _read("step_mfu.car", _car_run(with_tally=False)) is None
    assert _read("step_mfu.car", _car_run(trace=False)) is None
