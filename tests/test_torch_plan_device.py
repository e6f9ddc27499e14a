"""The k-NN grids' plans computed on the cloud's device
(`cupoch_tpu_torch.knn.plan_stats`) against the JAX package's host
plans on the CPU: for each of the four planners and each branch of
its sizing, the plan of a torch tensor equals the plan of the same
numpy input and the JAX package's, field by field and in type. A plan
reads back at most 3 small blocks, and `registration_icp` reads no
whole cloud to plan."""
import numpy as np
import pytest
import torch

import cupoch_tpu_torch as ctt
from cupoch_tpu.knn import cellgrid as jcg
from cupoch_tpu.knn import poolgrid as jpg
from cupoch_tpu.knn import rollgrid as jrl
from cupoch_tpu.knn import rungrid as jrg
from cupoch_tpu_torch.knn import cellgrid as tcg
from cupoch_tpu_torch.knn import plan_stats
from cupoch_tpu_torch.knn import poolgrid as tpg
from cupoch_tpu_torch.knn import rollgrid as trl
from cupoch_tpu_torch.knn import rungrid as trg
from cupoch_tpu_torch.utility import trace

PLANNERS = {"pool": (jpg.plan_poolgrid, tpg.plan_poolgrid),
            "run": (jrg.plan_rungrid, trg.plan_rungrid),
            "roll": (jrl.plan_rollgrid, trl.plan_rollgrid),
            "cell": (jcg.plan_cellgrid, tcg.plan_cellgrid)}
QUERIES = ("pool", "run")      # the planners that size a query side
R = 0.06
BETWEEN, ON_INTEGER = range(10, 101, 10), range(10, 111, 10)


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    yield
    trace.disable()


def _cube(rng, n=4000):
    return rng.uniform(size=(n, 3)).astype(np.float32)


def _shifted(p):
    return (p + np.float32([0.004, -0.003, 0.002])).astype(np.float32)


def _line_cells(counts, cell):
    """Points in cells two apart along x, `counts[i]` in the i-th: the
    cloud's lower corner is a point at 0.25 cell, the others lie 0.05
    to 0.35 cell past their cell's corner from it."""
    rng = np.random.default_rng(11)
    rows = []
    for i, c in enumerate(counts):
        p = rng.uniform(0.3, 0.6, size=(c, 3)) * cell
        p[:, 0] += 2 * i * cell
        rows.append(p)
    rows[0][0] = 0.25 * cell
    return np.concatenate(rows).astype(np.float32)


def _slab(rng, f):
    """The unit cube's share f along x, its far corners pinned: the
    pool plan's active share lies near its 0.55 compaction threshold."""
    p = _cube(rng, 6000)
    p[:, 0] *= f
    return np.concatenate([p, np.float32([[0, 0, 0], [1, 1, 1]])])


def _clumps(rng):
    """1000 cells of 4 points and 2 of 500: every cap up to 16 drops
    more than the budget, the 99.5th percentile is 4."""
    cell = R * 1.375
    pts = _line_cells([4] * 1000 + [500, 500], cell)
    return pts.reshape(-1, 3)


def _lattice(n=24):
    """Points on the lattice of the cell edge R, the float32 multiples
    that sit on cell boundaries: a cell id off by a rounding (a divisor
    applied as its reciprocal) moves them."""
    k = np.arange(n)
    g = np.stack(np.meshgrid(k, k, k, indexing="ij"), -1).reshape(-1, 3)
    return (g * R).astype(np.float32)


def _with_nan(p):
    p = p.copy()
    p[::97] = np.nan
    p[5::131, 1] = np.inf
    return p


# name: (cloud (rng -> target, queries), radius)
CLOUDS = {
    "cube": (lambda rng: (lambda t: (t, _shifted(t[:3000])))(_cube(rng)),
             R),
    "cube_nan": (lambda rng: (lambda t: (_with_nan(t),
                                         _with_nan(_shifted(t))))(
        _cube(rng)), R),
    "cube_f64": (lambda rng: (lambda t: (t.astype(np.float64),
                                         _shifted(t).astype(np.float64)))(
        _cube(rng)), R),
    "shell": (lambda rng: (lambda t: (t, _shifted(t)))(
        (1.0 + 0.95 * (lambda v: v / np.linalg.norm(v, axis=1,
                                                     keepdims=True))(
            rng.normal(size=(6000, 3)))).astype(np.float32)), R),
    "dense": (lambda rng: (lambda t: (t, _shifted(t)))(
        _cube(rng, 30000) * 0.2), R),
    "clumps": (lambda rng: (lambda t: (t, _shifted(t)))(_clumps(rng)), R),
    "slab_compact": (lambda rng: (lambda t: (t, _shifted(t[:3000])))(
        _slab(rng, 0.48)), R),
    "slab_dense": (lambda rng: (lambda t: (t, _shifted(t[:3000])))(
        _slab(rng, 0.5)), R),
    "lattice": (lambda rng: (_lattice(), _lattice()[::3] + np.float32(
        0.5 * R)), R),
    "all_nan": (lambda rng: (np.full((500, 3), np.nan, np.float32),
                             _cube(rng, 100)), R),
    "queries_away": (lambda rng: (lambda t: (t, t[:2000] + 100.0))(
        _cube(rng)), R),
    # counts 10, 20, .., 100 in line cells of 0.125 (the run plan's cell
    # at this radius; the roll and cell cases set it): the 55th
    # percentile falls between the 5th and 6th (index 4.95: 59.5, cap
    # 64); counts 10, .., 110 at the 50th on the 6th (60)
    "between": (lambda rng: (lambda t: (t, t))(
        _line_cells(BETWEEN, 0.125)), 0.1),
    "on_integer": (lambda rng: (lambda t: (t, t))(
        _line_cells(ON_INTEGER, 0.125)), 0.1),
}

# (planner, cloud, keyword arguments, accepted)
CASES = [
    ("pool", "cube", {}, True),                      # drop search finds
    ("pool", "clumps", {"cap_limit": 16}, True),     # falls to percentile
    ("pool", "dense", {}, False),                    # over cap_limit
    ("pool", "slab_compact", {}, True),
    ("pool", "slab_dense", {}, True),
    ("pool", "shell", {"shards": 4}, True),
    ("pool", "cube", {"max_cells": 1000}, False),
    ("pool", "cube", {"mem_budget_bytes": 1 << 20}, False),
    ("pool", "all_nan", {}, False),
    ("pool", "queries_away", {}, True),
    ("pool", "cube", {"qp_limit": 8}, False),
    ("pool", "cube", {"cap_percentile": 100.0}, True),   # the regrow
    ("pool", "cube_nan", {}, True),
    ("pool", "cube_f64", {}, True),
    ("pool", "lattice", {"margin": 0.0}, True),
    # the tile sums' percentile; the cap is found by the drop search
    ("pool", "between", {"margin": 0.25, "cap_percentile": 55.0}, True),
    ("pool", "on_integer", {"margin": 0.25, "cap_percentile": 50.0}, True),
    ("run", "cube", {}, True),
    ("run", "dense", {}, False),
    ("run", "cube", {"max_cells": 1000}, False),
    ("run", "cube", {"mem_budget_bytes": 1 << 20}, False),
    ("run", "all_nan", {}, False),
    ("run", "queries_away", {}, True),
    ("run", "cube_nan", {}, True),
    ("run", "cube_f64", {}, True),
    ("run", "lattice", {"margin": 0.0}, True),
    ("run", "between", {"cap_percentile": 55.0}, True),
    ("run", "on_integer", {"cap_percentile": 50.0}, True),
    # rungrid.knn_search_grid's plan
    ("run", "cube", {"margin": 0.0, "cap_percentile": 100.0,
                     "cap_limit": 256}, True),
    ("roll", "cube", {}, True),
    ("roll", "dense", {}, False),
    ("roll", "cube", {"max_cells": 1000}, False),
    ("roll", "cube", {"mem_budget_bytes": 1 << 20}, False),
    ("roll", "all_nan", {}, False),
    ("roll", "cube_nan", {}, True),
    ("roll", "lattice", {}, True),
    ("roll", "between", {"radius": 0.125, "cap_percentile": 55.0}, True),
    ("roll", "on_integer", {"radius": 0.125, "cap_percentile": 50.0}, True),
    ("cell", "shell", {}, True),
    ("cell", "dense", {}, False),
    ("cell", "cube", {"max_cells": 1000}, False),
    ("cell", "shell", {"mem_budget_bytes": 1 << 20}, False),
    ("cell", "all_nan", {}, False),
    ("cell", "cube_nan", {}, True),
    ("cell", "cube_f64", {}, True),
    ("cell", "lattice", {}, True),
    ("cell", "between", {"radius": 0.125, "cap_percentile": 55.0}, True),
    ("cell", "on_integer", {"radius": 0.125, "cap_percentile": 50.0}, True),
]


def _ids(case):
    planner, cloud, kw, _ = case
    return "-".join([planner, cloud] + [f"{k}={v}" for k, v in kw.items()])


def _plans(planner, cloud, kw):
    tgt, q = CLOUDS[cloud][0](np.random.default_rng(7))
    kw = dict(kw)
    r = kw.pop("radius", CLOUDS[cloud][1])
    jfn, tfn = PLANNERS[planner]
    qkw = [{"query_points": x} for x in (q, torch.as_tensor(q))] \
        if planner in QUERIES else [{}, {}]
    return (jfn(tgt, r, **qkw[0], **kw), tfn(tgt, r, **qkw[0], **kw),
            tfn(torch.as_tensor(tgt), r, **qkw[1], **kw))


def _assert_same(ref, got):
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert ref.keys() == got.keys()
    for k in ref:
        if ref[k] is None or got[k] is None:
            assert ref[k] is None and got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          np.asarray(got[k]), err_msg=k)


def _assert_types(plan):
    assert isinstance(plan["dims"], tuple)
    assert all(type(d) is int for d in plan["dims"])
    assert plan["origin"].dtype == np.float32
    assert isinstance(plan["cell_size"], np.float32)
    for k in ("cap", "kc", "qp", "qcap", "n_active", "tile", "shards"):
        if k in plan:
            assert type(plan[k]) is int, k
    if "rebin_margin" in plan:
        assert isinstance(plan["rebin_margin"], np.float32)
    for k in ("active_cells", "active"):
        if plan.get(k) is not None:
            assert torch.is_tensor(plan[k]) and plan[k].dtype == torch.int32


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_torch_plan_on_device_equals_reference(case):
    planner, cloud, kw, accepted = case
    pj, pn, pt = _plans(planner, cloud, kw)
    assert (pt is not None) == accepted
    _assert_same(pj, pn)
    _assert_same(pj, pt)
    if pt is not None:
        _assert_types(pt)
    if cloud.startswith("slab"):
        assert (pt["active_cells"] is not None) == (cloud == "slab_compact")
        share = pt["n_active"] / np.prod(pt["dims"])
        assert 0.5 < share < 0.6
    if cloud in ("between", "on_integer") and planner != "pool":
        # the percentile, 59.5 or 60, rounded up to 8
        assert pt["cap"] == 64
    if cloud == "clumps":
        # no cap up to the limit keeps the drops under budget: the
        # percentile (4, rounded up to 8) sets the cap
        assert pt["cap"] == 8
    if cloud == "queries_away":
        key = "qp" if planner == "pool" else "qcap"
        assert pt[key] == (16 * pt["tile"] if planner == "pool"
                           else max(8, -(-(int(pt["cap"] * 1.25) + 2)
                                         // 8) * 8))


@pytest.mark.parametrize("cloud, q, on_integer", [
    ("between", 55.0, False), ("on_integer", 50.0, True)])
def test_torch_plan_percentile_cases_land_as_named(cloud, q, on_integer):
    """The designed counts put numpy's percentile index on an integer or
    between two different counts, as the plan cases above name them."""
    counts = np.asarray(ON_INTEGER if on_integer else BETWEEN)
    v = (counts.size - 1) * q / 100.0
    assert (v == int(v)) == on_integer
    pct = np.percentile(counts, q)
    assert (pct == int(pct)) == on_integer


@pytest.mark.parametrize("seed", range(4))
def test_torch_plan_percentile_matches_numpy(seed):
    """`plan_stats.order_stats` and `percentile` give `np.percentile`'s
    value bit for bit, zeros left out, for counts and float sums."""
    rng = np.random.default_rng(seed)
    for trial in range(50):
        n = int(rng.integers(1, 300))
        x = rng.integers(0, 40, size=n) * (rng.uniform(size=n) < 0.6)
        if trial % 2:
            x = x.astype(np.float64) * 3.0
        qs = [float(rng.uniform(0, 100)), 99.5, 99.9, 100.0, 50.0]
        st = plan_stats.order_stats(
            plan_stats.ascending(torch.as_tensor(x)), qs).tolist()
        pos = x[x > 0]
        assert st[0] == pos.size
        for i, q in enumerate(qs):
            if pos.size:
                got = plan_stats.percentile(int(st[0]), st[1 + 2 * i],
                                            st[2 + 2 * i], q)
                assert got == np.percentile(pos, q)


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_torch_plan_reads_stay_small(planner):
    """On a 20k-point CPU tensor a plan reads at most 3 blocks, under 4
    KB together, all counted; its span says where it ran and how often
    it read; no plan counts as on the card."""
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(_cube(rng, 20000))
    kw = {"query_points": pts[:5000] + 0.003} if planner in QUERIES else {}
    trace.enable(reset=True)
    PLANNERS[planner][1](pts, 0.04, **kw)
    trace.disable()
    sp = trace.spans()
    reads = [s for s in sp if s.name == "host.read"]
    assert 1 <= len(reads) <= 3
    assert sum(s.attrs["bytes"] for s in reads) < 4096
    (plan,) = [s for s in sp if s.name == "knn.plan"]
    assert plan.attrs["planner"] == planner
    assert plan.attrs["device"] == "cpu"
    assert plan.attrs["reads"] == len(reads)
    c = trace.counters()
    assert c["host.reads"] == len(reads)
    assert not [k for k in c if k.startswith("knn.plan_on_card.")]


@pytest.mark.parametrize("planner", list(PLANNERS))
def test_torch_plan_traced_takes_numpy(planner):
    """With tracing on, a plan of numpy arrays (whose `device` is numpy's
    string "cpu") equals the plan untraced, and its span says cpu."""
    rng = np.random.default_rng(6)
    pts = _cube(rng, 20000)
    kw = {"query_points": _shifted(pts[:5000])} if planner in QUERIES \
        else {}
    plan_fn = PLANNERS[planner][1]
    want = plan_fn(pts, 0.04, **kw)
    trace.enable(reset=True)
    got = plan_fn(pts, 0.04, **kw)
    trace.disable()
    assert got is not None
    _assert_same(want, got)
    (plan,) = [s for s in trace.spans() if s.name == "knn.plan"]
    assert plan.attrs["device"] == "cpu" and plan.attrs["accepted"]
    assert 1 <= plan.attrs["reads"] <= 3


@pytest.mark.parametrize("param", ["knn", "hybrid"])
def test_torch_search_neighbors_traced_plans_run_grid(param):
    """`knn.search_neighbors` above the brute-force limit plans its run
    grid on the data's device with tracing on and answers as untraced."""
    rng = np.random.default_rng(8)
    data = _cube(rng, 24000)
    queries = _shifted(data[::4])
    p = ctt.knn.KDTreeSearchParamKNN(8) if param == "knn" \
        else ctt.knn.KDTreeSearchParamHybrid(0.05, 16)
    trg.clear_grid_cache()
    want = ctt.knn.search_neighbors(queries, data, p, device="cpu")
    trg.clear_grid_cache()
    trace.enable(reset=True)
    got = ctt.knn.search_neighbors(queries, data, p, device="cpu")
    trace.disable()
    trg.clear_grid_cache()
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    plans = [s.attrs for s in trace.spans() if s.name == "knn.plan"]
    assert plans and all(a["planner"] == "run" and a["device"] == "cpu"
                         and a["accepted"] for a in plans)
    assert max(s.attrs["bytes"] for s in trace.spans()
               if s.name == "host.read") < 4096


@pytest.mark.parametrize("scale, branch", [(1.0, "pool"), (0.43, "run")])
def test_torch_registration_plans_read_no_cloud(scale, branch):
    """`registration_icp` above the grid threshold plans on the clouds'
    device: no read is as large as a cloud."""
    rng = np.random.default_rng(9)
    m = 24000 if branch == "pool" else 30000
    tgt = _cube(rng, m) * np.float32(scale)
    tn = rng.normal(size=(m, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    target = ctt.geometry.PointCloud(tgt, device="cpu")
    target.normals = tn
    source = ctt.geometry.PointCloud(_shifted(tgt * np.float32(0.999)),
                                     device="cpu")
    trace.enable(reset=True)
    res = ctt.registration.registration_icp(
        source, target, 0.05,
        estimation=ctt.registration.TransformationEstimationPointToPlane(),
        criteria=ctt.registration.ICPConvergenceCriteria(max_iteration=2))
    trace.disable()
    sp = trace.spans()
    assert sp[0].attrs["branch"] == branch and res.fitness > 0.5
    cloud_bytes = 3 * 4 * m
    assert max(s.attrs["bytes"] for s in sp if s.name == "host.read") \
        < cloud_bytes
    plans = [s.attrs for s in sp if s.name == "knn.plan"]
    assert plans and all(p["device"] == "cpu" and p["reads"] <= 3
                         for p in plans)
