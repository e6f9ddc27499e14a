"""The hash grid's searches are exact on clouds whose buckets hold many
points: dense surfaces, a tiny table where every cell collides, and
repeated points. 1-NN, hybrid k-NN and radius counts equal a brute
force over every pair (distances each product and sum rounded on its
own, ties to the smaller index, the radius squared in float32), and
1-NN equals the benchmark's plain reference
(`benchmark/reference/grid_nn.py`, which squares the radius in float64
and so may count a point at the boundary otherwise); the search's
counters add up.
"""
import pytest
import torch

from benchmark.reference import grid_nn
from cupoch_tpu_torch.knn import gridhash
from cupoch_tpu_torch.utility import trace


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _d2(q, p):
    d = q[:, None, :] - p[None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return d2 + d[..., 2] * d[..., 2]


def _brute(q, p, radius, k):
    """(idx [Q, k], d2 [Q, k]) of the k nearest within radius by
    (distance, index); -1 / inf fill."""
    d2 = _d2(q, p)
    ok = d2 <= torch.tensor(radius, dtype=torch.float32) ** 2
    idx = torch.arange(p.shape[0]).expand_as(d2)
    key = torch.where(ok, (d2.view(torch.int32).long() << 32) | idx,
                      torch.iinfo(torch.int64).max)
    key = key.sort(1).values[:, :k]
    found = key != torch.iinfo(torch.int64).max
    return (torch.where(found, key & 0xFFFFFFFF, -1).to(torch.int32),
            torch.where(found, (key >> 32).to(torch.int32)
                        .view(torch.float32), float("inf")))


def _sheet(g, n, side, thick):
    """A noisy sheet: n points on [0, side]^2 x [0, thick]."""
    return torch.cat([torch.rand(n, 2, generator=g) * side,
                      torch.rand(n, 1, generator=g) * thick], 1)


def _clouds():
    g = torch.Generator().manual_seed(7)
    sheet = _sheet(g, 20000, 0.5, 0.002)
    # queries off the sheet, some past the radius
    near = _sheet(g, 2500, 0.5, 0.14) - torch.tensor([0.0, 0.0, 0.07])
    dups = torch.cat([torch.rand(2000, 3, generator=g) * 0.2,
                      torch.full((400, 3), 0.1)])
    return {
        # buckets of hundreds of points at the radius
        "dense_sheet": (sheet, near, 0.05, 0),
        # 64 buckets for 3000 points: every bucket collides
        "tiny_table": (torch.rand(3000, 3, generator=g) * 0.3,
                       torch.rand(800, 3, generator=g) * 0.3, 0.05, 64),
        # 400 copies of one point: ties broken by index
        "repeated": (dups, torch.rand(600, 3, generator=g) * 0.2, 0.04, 0),
    }


CLOUDS = _clouds()


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_gridhash_overflowing_buckets_need_more_than_the_old_cap(name):
    """Each cloud has buckets past the 32 points the capped search read."""
    pts, _, r, table = CLOUDS[name]
    grid = gridhash.build_grid(pts, r, table_size=table)
    assert int(grid.bucket_count.max()) > 32


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_gridhash_query_nn_is_exact(name):
    pts, q, r, table = CLOUDS[name]
    grid = gridhash.build_grid(pts, r, table_size=table)
    idx, d2 = gridhash.query_nn(grid, q, r)
    want_i, want_d = _brute(q, pts, r, 1)
    assert torch.equal(idx, want_i[:, 0])
    assert torch.equal(d2, want_d[:, 0])
    ref_i, ref_d = grid_nn.NearestIndex(pts, r).nearest(q)
    assert torch.equal(idx.long(), ref_i)
    assert torch.equal(d2, ref_d)
    assert (idx >= 0).any()
    assert (idx < 0).any() or name != "dense_sheet"


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_gridhash_query_hybrid_is_exact(name):
    pts, q, r, table = CLOUDS[name]
    grid = gridhash.build_grid(pts, r, table_size=table)
    idx, d2, cnt = gridhash.query_hybrid(grid, q, r, 12)
    want_i, want_d = _brute(q, pts, r, 12)
    assert torch.equal(idx, want_i)
    assert torch.equal(d2, want_d)
    assert torch.equal(cnt, (want_i >= 0).sum(1).to(torch.int32))


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_gridhash_query_radius_count_is_exact(name):
    pts, q, r, table = CLOUDS[name]
    grid = gridhash.build_grid(pts, r, table_size=table)
    cnt = gridhash.query_radius_count(grid, q, r)
    want = (_d2(q, pts) <= torch.tensor(r, dtype=torch.float32) ** 2).sum(1)
    assert torch.equal(cnt.long(), want)


def test_gridhash_masked_rows_and_queries():
    """Masked points are never found; masked queries find nothing."""
    pts, q, r, _ = CLOUDS["dense_sheet"]
    keep = torch.arange(pts.shape[0]) % 3 != 0
    qmask = torch.arange(q.shape[0]) % 4 != 0
    grid = gridhash.build_grid(pts, r, mask=keep)
    idx, d2 = gridhash.query_nn(grid, q, r, query_mask=qmask)
    kept = torch.nonzero(keep)[:, 0]
    want_i, want_d = _brute(q, pts[kept], r, 1)
    want_i = torch.where(want_i[:, 0] >= 0, kept[want_i[:, 0].clamp(min=0)],
                         -1).to(torch.int32)
    assert torch.equal(idx, torch.where(qmask, want_i, -1))
    assert torch.equal(d2, torch.where(qmask, want_d[:, 0], float("inf")))


def test_gridhash_chunks_hold_the_pair_budget(monkeypatch):
    """A budget far below the pairs of one call splits the queries into
    chunks and changes no answer."""
    pts, q, r, _ = CLOUDS["dense_sheet"]
    grid = gridhash.build_grid(pts, r)
    whole = gridhash.query_hybrid(grid, q, r, 8)
    monkeypatch.setattr(gridhash, "PAIR_BUDGET", 5000)
    split = gridhash.query_hybrid(grid, q, r, 8)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_gridhash_counters():
    """`gridhash.queries`, `.slots` and `.rescued` count each call's
    queries, the pairs it scanned and the queries past the finest
    level; off, nothing is counted."""
    pts, q, r, _ = CLOUDS["dense_sheet"]
    grid = gridhash.build_grid(pts, r)
    assert len(grid.levels) > 1
    trace.disable()
    trace.enable()
    try:
        idx, _ = gridhash.query_nn(grid, q, r)
        c = trace.counters()
        assert c["gridhash.queries"] == q.shape[0]
        rescued = c["gridhash.rescued"]
        assert 0 < rescued < q.shape[0]
        # every query scans its finest block; the rescued ones more
        finest = grid.levels[-1]
        start, count = gridhash._runs(grid, finest, q)
        assert c["gridhash.slots"] > int(count.sum())
        gridhash.query_radius_count(grid, q, r)
        c2 = trace.counters()
        assert c2["gridhash.queries"] == 2 * q.shape[0]
        assert c2["gridhash.rescued"] == rescued
        _, count0 = gridhash._runs(grid, grid.levels[0], q)
        assert c2["gridhash.slots"] - c["gridhash.slots"] == int(count0.sum())
        # the reads the search makes go through trace.to_host
        assert c2["host.reads"] >= 3
    finally:
        trace.disable()
    trace.enable()
    trace.disable()
    gridhash.query_nn(grid, q, r)
    assert trace.counters().get("gridhash.queries") is None
