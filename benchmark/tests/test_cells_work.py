"""The correspondence kernel's work count on a case counted by hand,
and the exact neighbour search it rests on against brute force."""
import torch

from benchmark.lib.work import correspondence_work
from benchmark.reference import grid_nn


def test_work_by_hand():
    targets = torch.tensor([[0.0, 0.0, 0.0], [0.015, 0.0, 0.0],
                            [0.0, 0.05, 0.0], [1.0, 1.0, 1.0]])
    queries = torch.tensor([[0.005, 0.0, 0.0], [1.0, 1.0, 1.01],
                            [5.0, 5.0, 5.0]])
    w = correspondence_work(queries, targets, 0.02)
    # query 0 sees targets 0 and 1, query 1 sees target 3, query 2 none
    assert w["pairs"] == 3
    assert w["ops"] == 3 * 8
    assert w["bytes"] == 4 * 24 + 3 * 12 + 3 * 4


def test_grid_search_is_exact():
    g = torch.Generator().manual_seed(5)
    pts = torch.rand((3000, 3), generator=g)
    q = torch.rand((500, 3), generator=g)
    r = 0.08
    d2 = ((q[:, None] - pts[None]) ** 2).sum(-1)
    best = torch.where(d2 <= r * r, d2, float("inf")).min(1)
    idx, dist = grid_nn.NearestIndex(pts, r).nearest(q)
    hit = torch.isfinite(best.values)
    assert torch.equal(idx >= 0, hit)
    assert torch.equal(idx[hit], best.indices[hit])
    assert torch.equal(dist[hit], best.values[hit])
    cnt = grid_nn.count_within(grid_nn.Grid(pts, r), q)
    assert torch.equal(cnt, (d2 <= r * r).sum(1))


def test_hybrid_normals_are_exact():
    from benchmark.reference import normals
    g = torch.Generator().manual_seed(8)
    u = torch.rand((1500, 2), generator=g)
    floor = torch.cat([u, torch.zeros(1500, 1)], 1)
    wall = torch.stack([u[:, 0], torch.full((1500,), 1.0), u[:, 1]], 1)
    pts = torch.cat([floor, wall]) + 1e-3 * torch.randn((3000, 3),
                                                        generator=g)
    r, k = 0.1, 12
    idx = normals.hybrid_neighbours(pts, r, k)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    d2 = torch.where(d2 <= r * r, d2, float("inf"))
    val, near = d2.topk(k, largest=False)
    want = torch.where(torch.isfinite(val), near, -1)
    assert torch.equal(idx, want)
    n = normals.estimate(pts, r, k)
    # more than a radius from the fold each normal is its plane's
    on_floor = torch.arange(3000) < 1500
    far = torch.where(on_floor, pts[:, 1] < 1.0 - r, pts[:, 2] > r)
    dots = torch.where(on_floor, n[:, 2].abs(), n[:, 1].abs())
    assert float(dots[far].min()) > 0.99
