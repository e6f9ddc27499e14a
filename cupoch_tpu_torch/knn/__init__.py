"""Neighbour search (cupoch knn/): brute force (`bruteforce`), the
pooled correspondence grid of the ICP path (`poolgrid`, with its CUDA
slot kernel in `poolgrid_slot`), the run-structured grid (`rungrid`,
with its CUDA fused pass in `rungrid_fused`, its Gaussian-moment pass
in `rungrid_gmm` and its k-NN), the dense roll grid and the
active-cell grid (`rollgrid`, `cellgrid`, both reduced by the CUDA
kernel in `rollgrid_nn`) and the hash grid (`gridhash`).

`KDTreeFlann` keeps cupoch's class name and query API
(knn/kdtree_flann.h) over brute force and the grids.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import (bruteforce, cellgrid, gridhash, poolgrid, poolgrid_slot,
               rollgrid, rollgrid_nn, rungrid, rungrid_fused, rungrid_gmm)
from .bruteforce import hybrid_search, knn_search, nn_search
from .gridhash import (HashGrid, build_grid, query_hybrid, query_nn,
                       query_radius_count)
from ..utility.device import resolve_device

NUM_MAX_NN = 100  # cupoch knn/kdtree_search_param.h


class KDTreeSearchParam:
    class SearchType:
        Knn = 0
        Radius = 1
        Hybrid = 2

    def __init__(self, search_type):
        self.search_type = search_type

    def get_search_type(self):
        return self.search_type


class KDTreeSearchParamKNN(KDTreeSearchParam):
    def __init__(self, knn: int = 30):
        super().__init__(KDTreeSearchParam.SearchType.Knn)
        self.knn = int(knn)


class KDTreeSearchParamRadius(KDTreeSearchParam):
    def __init__(self, radius: float, max_nn: int = NUM_MAX_NN):
        super().__init__(KDTreeSearchParam.SearchType.Radius)
        self.radius = float(radius)
        self.max_nn = int(max_nn)


class KDTreeSearchParamHybrid(KDTreeSearchParam):
    def __init__(self, radius: float, max_nn: int):
        super().__init__(KDTreeSearchParam.SearchType.Hybrid)
        self.radius = float(radius)
        self.max_nn = int(max_nn)


# brute force is exact and cheap below this many data points
_BRUTE_FORCE_LIMIT = 20000


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def search_neighbors(queries, data, param: KDTreeSearchParam,
                     data_mask=None, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([Q, k] indices, [Q, k] squared distances), -1 / inf fill, on
    the device of `data` (a tensor), else `device` (default "cuda").
    Mirrors cupoch KDTreeFlann::Search: brute force up to 20k data
    points, the run grid above, brute force (k-NN) or the hash grid
    (radius) when no grid plan suits the cloud."""
    dev = data.device if isinstance(data, torch.Tensor) \
        else resolve_device(device)
    queries = _as_tensor(queries, dev)
    data = _as_tensor(data, dev)
    if data_mask is not None:
        data_mask = torch.as_tensor(data_mask).to(dev)
    st = param.get_search_type()
    big = data.shape[0] > _BRUTE_FORCE_LIMIT
    if st == KDTreeSearchParam.SearchType.Knn:
        if big:
            out = rungrid.knn_search_grid(
                None, data.cpu().numpy(), param.knn,
                data_mask=data_mask, queries_dev=queries, data_dev=data)
            if out is not None:
                return out
        return bruteforce.knn_search(queries, data, param.knn,
                                     data_mask=data_mask)
    radius, max_nn = param.radius, param.max_nn
    if not big:
        idx, d2, _ = bruteforce.hybrid_search(queries, data, radius, max_nn,
                                              data_mask=data_mask)
        return idx, d2
    out = rungrid.knn_search_grid(
        None, data.cpu().numpy(), max_nn, radius=radius,
        data_mask=data_mask, queries_dev=queries, data_dev=data)
    if out is not None:
        return out
    grid = gridhash.build_grid(data, radius, mask=data_mask)
    idx, d2, _ = gridhash.query_hybrid(grid, queries, radius, max_nn)
    return idx, d2


class KDTreeFlann:
    """cupoch's KDTreeFlann query API (search_knn, search_radius,
    search_hybrid) over the port's search backends. `device` places
    data given as an array (default "cuda"); a tensor keeps its own."""

    def __init__(self, data=None, device=None):
        self._data = None
        self._device = device
        if data is not None:
            # a raw array or a geometry with .points
            self.set_raw_data(getattr(data, "points", data))

    def set_raw_data(self, data):
        dev = data.device if isinstance(data, torch.Tensor) \
            else resolve_device(self._device)
        self._data = _as_tensor(data, dev)
        return True

    def search(self, query, param: KDTreeSearchParam):
        """(neighbours found for the first query, idx [Q, k] and d2
        [Q, k] as numpy arrays)."""
        q = _as_tensor(query, self._data.device)
        idx, d2 = search_neighbors(q.reshape(-1, 3), self._data, param)
        idx, d2 = idx.cpu().numpy(), d2.cpu().numpy()
        return int((idx[0] >= 0).sum()), idx, d2

    def search_knn(self, query, knn: int):
        return self.search(query, KDTreeSearchParamKNN(knn))

    def search_radius(self, query, radius: float, max_nn: int = NUM_MAX_NN):
        return self.search(query, KDTreeSearchParamRadius(radius, max_nn))

    def search_hybrid(self, query, radius: float, max_nn: int):
        return self.search(query, KDTreeSearchParamHybrid(radius, max_nn))


__all__ = [
    "KDTreeFlann",
    "KDTreeSearchParam",
    "KDTreeSearchParamKNN",
    "KDTreeSearchParamRadius",
    "KDTreeSearchParamHybrid",
    "NUM_MAX_NN",
    "search_neighbors",
    "knn_search",
    "nn_search",
    "hybrid_search",
    "HashGrid",
    "build_grid",
    "query_nn",
    "query_hybrid",
    "query_radius_count",
    "bruteforce",
    "cellgrid",
    "gridhash",
    "poolgrid",
    "poolgrid_slot",
    "rollgrid",
    "rollgrid_nn",
    "rungrid",
    "rungrid_fused",
    "rungrid_gmm",
]
