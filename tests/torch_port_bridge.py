"""Turn the JAX package's objects into the PyTorch port's through
numpy, so both packages compute on identical inputs: point clouds
(with normals, colours and covariances), images and RGB-D pairs,
camera intrinsics, features and the FGR option, triangle meshes (bare,
or with their normals, colours, UVs and texture), voxel and occupancy
grids, distance transforms, line sets, graphs and laser scan buffers
(the last five through the port's `from_numpy`), the scalable TSDF
volume's block table and state, SGM options, pose graphs, bundle
adjustment problems and pooled grids built for a ring of ranks (one
rank's shard of the score table). A helper of the port's parity tests (tests/test_torch_*.py)."""
import numpy as np

import cupoch_tpu_torch.registration as treg
from cupoch_tpu_torch.geometry import PointCloud as TPointCloud


def cloud(jpcd, device="cpu") -> TPointCloud:
    out = TPointCloud(np.asarray(jpcd.points), device=device)
    for name in ("normals", "colors", "covariances"):
        v = getattr(jpcd, name)
        if v is not None:
            setattr(out, name, np.asarray(v))
    return out


def feature(jfeat, device="cpu") -> treg.Feature:
    return treg.Feature(np.asarray(jfeat.data), device=device)


def fgr_option(jopt) -> treg.FastGlobalRegistrationOption:
    return treg.FastGlobalRegistrationOption(**vars(jopt))


def inject_jax_fgr_choices(monkeypatch):
    """Make the port's FGR use the JAX package's tuple draws
    (`PRNGKey(0)`) and its f32 feature-space nearest neighbours, which
    differ from the port's f64 picks on near-ties: both packages then
    optimise over the same pairs."""
    import importlib

    import jax
    import jax.numpy as jnp
    import torch
    from cupoch_tpu.registration import feature as jfeat

    tfgr = importlib.import_module(
        "cupoch_tpu_torch.registration.fast_global_registration")

    def draws(ncorr, n_trials):
        return torch.as_tensor(np.array(jax.random.randint(
            jax.random.PRNGKey(0), (n_trials, 3), 0, ncorr)),
            dtype=torch.int64)

    def feature_nn(q, d):
        nn = jfeat._feature_nn(jnp.asarray(q.cpu().numpy()),
                               jnp.asarray(d.cpu().numpy()))
        return torch.as_tensor(np.array(nn), dtype=torch.int64,
                               device=q.device)

    monkeypatch.setattr(tfgr, "tuple_draws", draws)
    monkeypatch.setattr(tfgr, "_feature_nn", feature_nn)


def image(jimg, device="cpu"):
    """The port's Image of a JAX package Image (same data and dtype)."""
    from cupoch_tpu_torch.geometry import Image

    return Image(np.asarray(jimg.data), device=device)


def rgbd(jrgbd, device="cpu"):
    from cupoch_tpu_torch.geometry import RGBDImage

    return RGBDImage(image(jrgbd.color, device), image(jrgbd.depth, device))


def intrinsic(jintr):
    """The port's PinholeCameraIntrinsic of a JAX package one."""
    from cupoch_tpu_torch.camera import PinholeCameraIntrinsic

    return PinholeCameraIntrinsic.from_dict(jintr.to_dict())



def mesh(jmesh, device="cpu"):
    from cupoch_tpu_torch.geometry import TriangleMesh

    return TriangleMesh(np.array(jmesh.vertices), np.array(jmesh.triangles),
                        device=device)


def textured_mesh(jmesh, device="cpu"):
    """The port's mesh with the JAX mesh's vertex normals and colours,
    corner UVs and texture, where it has them."""
    out = mesh(jmesh, device)
    for name in ("vertex_normals", "vertex_colors", "triangle_uvs"):
        v = getattr(jmesh, name)
        if v is not None:
            setattr(out, name, np.asarray(v))
    if jmesh.texture is not None:
        out.texture = image(jmesh.texture, device)
    return out


def scalable_volume(jvol, device="cpu"):
    """The port's ScalableTSDFVolume holding the JAX volume's block
    table and state."""
    from cupoch_tpu_torch.integration import ScalableTSDFVolume

    return ScalableTSDFVolume.from_numpy(
        dict(jvol._slots), np.asarray(jvol.tsdf), np.asarray(jvol.weight),
        np.asarray(jvol.color), jvol.voxel_length, jvol.sdf_trunc,
        int(jvol.color_type), jvol.depth_sampling_stride, device=device)


def sgm_option(jopt):
    from cupoch_tpu_torch.imageproc import SGMOption

    return SGMOption(**vars(jopt))


def voxel_grid(jvg, device="cpu"):
    from cupoch_tpu_torch.geometry import VoxelGrid

    return VoxelGrid.from_numpy(np.asarray(jvg.voxels_keys),
                                np.asarray(jvg.voxels_colors),
                                jvg.voxel_size, jvg.origin, device=device)


def occupancy_grid(jog, device="cpu"):
    from cupoch_tpu_torch.geometry import OccupancyGrid

    return OccupancyGrid.from_numpy(
        np.asarray(jog.prob_log), jog.voxel_size, jog.origin, jog.min_bound,
        jog.max_bound, jog.clamping_thres_min, jog.clamping_thres_max,
        jog.prob_hit_log, jog.prob_miss_log, jog.occ_prob_thres_log,
        device=device)


def distance_transform(jdt, device="cpu"):
    from cupoch_tpu_torch.geometry import DistanceTransform

    return DistanceTransform.from_numpy(np.asarray(jdt.distance),
                                        np.asarray(jdt.nearest_index),
                                        jdt.voxel_size, jdt.origin,
                                        device=device)


def line_set(jls, device="cpu"):
    from cupoch_tpu_torch.geometry import LineSet

    return LineSet.from_numpy(np.asarray(jls.points), np.asarray(jls.lines),
                              np.asarray(jls.colors), dim=jls.dim,
                              device=device)


def graph(jg, device="cpu"):
    from cupoch_tpu_torch.geometry import Graph

    return Graph.from_numpy(np.asarray(jg.points), np.asarray(jg.lines),
                            np.asarray(jg.edge_weights), jg.is_directed,
                            dim=jg.dim, device=device)


def laser_scan(jbuf, device="cpu"):
    from cupoch_tpu_torch.geometry import LaserScanBuffer

    return LaserScanBuffer.from_numpy(
        np.asarray(jbuf.ranges), np.asarray(jbuf.origins), jbuf.top_,
        jbuf.bottom_, jbuf.min_angle_, jbuf.max_angle_,
        None if jbuf.intensities is None else np.asarray(jbuf.intensities),
        device=device)


def pose_graph(jg):
    import cupoch_tpu_torch.slam as tslam

    g = tslam.PoseGraph()
    g.nodes = [tslam.PoseGraphNode(np.array(n.pose)) for n in jg.nodes]
    g.edges = [tslam.PoseGraphEdge(e.source_node_id, e.target_node_id,
                                   np.array(e.transformation),
                                   np.array(e.information), e.uncertain,
                                   e.confidence) for e in jg.edges]
    return g


def ba_problem(jp):
    import cupoch_tpu_torch.slam as tslam

    return tslam.BAProblem(*(np.array(a) for a in jp))


def pool_grid_shard(jgrid, rank: int, n_shards: int, device="cpu"):
    """The port's grid of a JAX PoolGrid built with `shards=n_shards`,
    its score table cut to rank `rank`'s block of supertiles (what that
    rank of the ring holds before the first rotation)."""
    from cupoch_tpu_torch.knn.poolgrid import PoolGrid

    g = PoolGrid.from_numpy(
        np.asarray(jgrid.scan), np.asarray(jgrid.scan_lo),
        np.asarray(jgrid.binfields), np.asarray(jgrid.origin),
        np.asarray(jgrid.cell_size), np.asarray(jgrid.off), jgrid.dims,
        jgrid.cap, jgrid.kc, jgrid.est, jgrid.tile,
        n_dropped=np.asarray(jgrid.n_dropped),
        cell_map=None if jgrid.cell_map is None
        else np.asarray(jgrid.cell_map), device=device)
    rows = g.table.shape[0] // n_shards
    g.table = g.table[rank * rows:(rank + 1) * rows].clone()
    return g
