"""The brute-force 1-NN kernel (`csrc/bruteforce_nn.cu`, through
`knn.bruteforce.nn_search`) on the card, bit for bit against its plain
version `nn_search_plain` on the same card: at KinFu's level-1 shapes
(a 320x240 rendered room onto the next frame's, padded as
`registration_icp` pads them, with duplicated points and a scattered
mask) and at a query count too small to fill the card, where the
points are split over many blocks; and `registration_icp`'s brute-force
branch launches it. Skips without a CUDA card; imports no JAX, so it
runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_bruteforce_card.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from cupoch_tpu_torch.knn import bruteforce
from cupoch_tpu_torch.utility import trace
from cupoch_tpu_torch.utility.shape import bucket_size, pad_axis0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.card
@pytest.mark.parametrize("mask", ["prefix", "scattered"])
def test_kernel_matches_plain_at_level_one(card, mask):
    src = chip_smoke.rendered_surface(np, 3, 1)
    tgt = chip_smoke.rendered_surface(np, 4, 1)
    # duplicates: every 97th target point again at the end, and source
    # points lying exactly on target points
    n0 = len(tgt)
    tgt = np.concatenate([tgt, tgt[::97]])
    src[::53] = tgt[:len(src[::53])]
    nq, nd = len(src), len(tgt)
    assert 70_000 < nq < nd
    q = pad_axis0(torch.as_tensor(src), bucket_size(nq)).to(card)
    d = pad_axis0(torch.as_tensor(tgt), bucket_size(nd)).to(card)
    rng = np.random.default_rng(17)
    keep = np.arange(d.shape[0]) < nd
    if mask == "scattered":
        keep &= rng.uniform(size=d.shape[0]) > 0.2
    m = torch.as_tensor(keep).to(card)
    bruteforce.launches = 0
    got = bruteforce.nn_search(q, d, data_mask=m, n_queries=nq, n_data=nd)
    torch.cuda.synchronize()
    assert bruteforce.launches == 1
    want = bruteforce.nn_search_plain(q, d, m, nq, nd)
    _same(got, want)
    idx, d2 = got[0].cpu().numpy(), got[1].cpu().numpy()
    assert (idx[nq:] == -1).all() and np.isinf(d2[nq:]).all()
    assert (idx[:nq] >= 0).all() and keep[idx[:nq]].all()
    if mask == "prefix":
        # a point and its later copy tie: the first wins
        on = np.arange(0, nq, 53)
        assert (d2[on] == 0.0).all()
        assert (idx[on] == np.arange(len(on))).all() and n0 < nd
        # the padded call, padding masked, gives the same answer
        full = bruteforce.nn_search(q, d, data_mask=m)
        torch.cuda.synchronize()
        assert torch.equal(full[0][:nq], got[0][:nq])
        assert torch.equal(full[1][:nq], got[1][:nq])


@pytest.mark.card
def test_kernel_splits_a_small_query_count(card):
    """4.8k queries (level 3) make 5 query blocks of 1024, far fewer than
    the card holds: the kernel splits the 10.3k points (41 tiles of 256)
    over as many blocks as fill the card, up to a tile each, and they
    meet in the atomic minimum."""
    src = chip_smoke.rendered_surface(np, 3, 3)
    tgt = chip_smoke.rendered_surface(np, 4, 3)
    n0 = len(tgt)
    tgt = np.concatenate([tgt, tgt[::7], tgt])
    q = torch.as_tensor(src).to(card)
    d = torch.as_tensor(tgt).to(card)
    got = bruteforce.nn_search(q, d)
    want = bruteforce.nn_search_plain(q, d)
    torch.cuda.synchronize()
    _same(got, want)
    # every point has a later copy: the first always wins
    assert (got[0].cpu().numpy() < n0).all()
    m = torch.zeros(len(tgt), dtype=torch.bool, device=card)
    none = bruteforce.nn_search(q, d, data_mask=m)
    assert (none[0] == -1).all() and torch.isinf(none[1]).all()


@pytest.mark.card
def test_registration_brute_branch_launches_the_kernel(card):
    import cupoch_tpu_torch as ctt
    from cupoch_tpu_torch.registration import registration as regmod
    src = chip_smoke.rendered_surface(np, 3, 2)
    tgt = chip_smoke.rendered_surface(np, 4, 2)
    assert len(tgt) <= regmod._GRID_THRESHOLD
    s = ctt.geometry.PointCloud(src, device=card)
    t = ctt.geometry.PointCloud(tgt, device=card)
    trace.reset_launch_counts()
    trace.enable(reset=True)
    try:
        res = ctt.registration.registration_icp(s, t, 0.1)
    finally:
        trace.disable()
    c = trace.counters()
    assert c["registration.branch.brute"] == 1
    assert c["launches.bruteforce_nn"] == res.iterations + 1
    assert c["bruteforce.pairs"] == (res.iterations + 1) * len(src) \
        * len(tgt)
    assert res.fitness > 0.9
