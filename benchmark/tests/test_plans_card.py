"""The k-NN grids' plans on the card (`cupoch_tpu_torch.knn.plan_stats`):
each of the four planners, given a CUDA tensor, plans as it does on the
same cloud on the CPU, counts `knn.plan_on_card.<planner>` and waits on
the card only in its counted reads (at most 3, under 4 KB together);
a pooled `registration_icp` on the card counts its pool plan there and
reads no whole cloud. Skips without a CUDA card."""
import warnings

import numpy as np
import pytest
import torch

from cupoch_tpu_torch.knn import cellgrid, poolgrid, rollgrid, rungrid
from cupoch_tpu_torch.utility import trace

PLANNERS = {"pool": poolgrid.plan_poolgrid, "run": rungrid.plan_rungrid,
            "roll": rollgrid.plan_rollgrid, "cell": cellgrid.plan_cellgrid}
QUERIES = ("pool", "run")


def _same(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        assert type(x) is type(y), k
        if torch.is_tensor(x):
            x, y = x.cpu().numpy(), y.cpu().numpy()
        assert np.array_equal(np.asarray(x), np.asarray(y)), k


@pytest.mark.card
@pytest.mark.parametrize("planner", list(PLANNERS))
def test_plan_on_the_card(card, planner):
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(size=(200000, 3)).astype(np.float32))
    kw = {"query_points": pts[::2] + 0.001} if planner in QUERIES else {}
    want = PLANNERS[planner](pts, 0.03, **kw)
    pts_d = pts.to(card)
    kw_d = {k: v.to(card) for k, v in kw.items()}
    torch.cuda.synchronize()
    trace.enable(reset=True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            got = PLANNERS[planner](pts_d, 0.03, **kw_d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.disable()
    assert want is not None
    _same(want, got)
    for k in ("active_cells", "active"):
        if got.get(k) is not None:
            assert got[k].device.type == "cuda"
    reads = [s for s in trace.spans() if s.name == "host.read"]
    assert 1 <= len(reads) <= 3
    assert sum(s.attrs["bytes"] for s in reads) < 4096
    syncs = [w for w in ws if "ynchroniz" in str(w.message)]
    assert len(syncs) <= len(reads), [str(w.message) for w in syncs]
    (span,) = [s for s in trace.spans() if s.name == "knn.plan"]
    assert span.attrs["device"] == "cuda"
    assert span.attrs["reads"] == len(reads)
    assert trace.counters()[f"knn.plan_on_card.{planner}"] == 1


@pytest.mark.card
def test_pooled_icp_plans_on_the_card(card):
    import cupoch_tpu_torch as ctt
    rng = np.random.default_rng(9)
    m = 24000
    tgt = rng.uniform(size=(m, 3)).astype(np.float32)
    tn = rng.normal(size=(m, 3)).astype(np.float32)
    tn /= np.linalg.norm(tn, axis=1, keepdims=True)
    target = ctt.geometry.PointCloud(tgt, device="cuda")
    target.normals = tn
    src = tgt * np.float32(0.999) + np.float32([0.004, -0.003, 0.002])
    source = ctt.geometry.PointCloud(src.astype(np.float32), device="cuda")
    trace.enable(reset=True)
    try:
        ctt.registration.registration_icp(
            source, target, 0.05,
            estimation=ctt.registration.
            TransformationEstimationPointToPlane(),
            criteria=ctt.registration.ICPConvergenceCriteria(
                max_iteration=2))
    finally:
        trace.disable()
    sp = trace.spans()
    assert sp[0].attrs["branch"] == "pool"
    assert trace.counters()["knn.plan_on_card.pool"] >= 1
    assert max(s.attrs["bytes"] for s in sp if s.name == "host.read") \
        < 3 * 4 * m
