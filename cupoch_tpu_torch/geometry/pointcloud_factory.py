"""PointCloud factories from depth, RGB-D and disparity images (cupoch
geometry/pointcloud_factory.cu).

Each projects a whole image at once on the image's device and keeps the
valid pixels in row-major order; bound as `PointCloud` static methods.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utility import console
from ..utility.device import resolve_device
from .image_ops import _f32


def _image_tensor(img, device) -> torch.Tensor:
    """The data of an Image (on its device) or of an array (on
    `device`, None meaning the card)."""
    if hasattr(img, "data") and isinstance(img.data, torch.Tensor):
        return img.data
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.array(img)).to(resolve_device(device))


def _cam_pose(extrinsic, device) -> torch.Tensor:
    """The camera-to-world pose of a world-to-camera `extrinsic`, the
    inverse taken on the host in f32."""
    T = np.eye(4, dtype=np.float32) if extrinsic is None \
        else np.asarray(extrinsic, np.float32)
    return torch.as_tensor(np.linalg.inv(T), device=device)


def _intrinsics(intrinsic, device):
    fx, fy = intrinsic.get_focal_length()
    cx, cy = intrinsic.get_principal_point()
    return (_f32(fx, device), _f32(fy, device), _f32(cx, device),
            _f32(cy, device))


def _camera_xyz(d, fx, fy, cx, cy, stride: int = 1) -> torch.Tensor:
    """[H, W, 3] camera-frame points of depth `d` [H, W] sampled every
    `stride` pixels."""
    H, W = d.shape
    col = (torch.arange(W, dtype=torch.float32, device=d.device)
           * stride)[None, :]
    row = (torch.arange(H, dtype=torch.float32, device=d.device)
           * stride)[:, None]
    x = (col - cx) * d / fx
    y = (row - cy) * d / fy
    return torch.stack([x, y, d], -1)


def create_from_depth_image(depth, intrinsic, extrinsic=None,
                            depth_scale: float = 1000.0,
                            depth_trunc: float = 1000.0, stride: int = 1,
                            device=None):
    """cupoch PointCloud::CreateFromDepthImage: a float depth image in
    metres, or a uint16 one scaled by depth_scale and cut at
    depth_trunc; points in the world frame of `extrinsic`."""
    from .pointcloud import PointCloud

    d = _image_tensor(depth, device)
    if d.ndim == 3:
        if d.shape[2] != 1:
            console.log_error("[PointCloud::CreateFromDepthImage] "
                              "Unsupported image format.")
        d = d[..., 0]
    if d.dtype == torch.uint16:
        d = d.to(torch.float32) / float(depth_scale)
        d = torch.where(d > depth_trunc, 0.0, d)
    elif d.dtype != torch.float32:
        console.log_error("[PointCloud::CreateFromDepthImage] "
                          "Unsupported image format.")
    dev = d.device
    pose = _cam_pose(extrinsic, dev)
    d = d[::stride, ::stride]
    pts = _camera_xyz(d, *_intrinsics(intrinsic, dev), stride=stride)
    pts = pts.reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]
    return PointCloud(pts[(d > 0.0).reshape(-1)], device=dev)


def create_from_rgbd_image(image, intrinsic, extrinsic=None,
                           project_valid_depth_only: bool = True,
                           depth_cutoff: float = -1.0,
                           compute_normals: bool = False):
    """cupoch PointCloud::CreateFromRGBDImage: points, colours and,
    when asked, image-gradient normals (the cross product of the
    forward row and column differences) of the pixels with a finite
    positive depth (at most `depth_cutoff` when that is positive); or
    every pixel, NaN where the depth is invalid."""
    from .pointcloud import PointCloud

    d = image.depth.data
    dev = d.device
    if d.ndim == 3:
        d = d[..., 0]
    d = d.to(torch.float32)
    if depth_cutoff > 0:
        d = torch.where(d > depth_cutoff, 0.0, d)
    c = image.color.data.to(dev)
    if c.ndim == 2:
        c = c[..., None]
    if c.dtype == torch.uint8:
        c = c.to(torch.float32) / 255.0
    c = c.to(torch.float32)
    if c.shape[-1] == 1:
        c = c.expand(-1, -1, 3)
    pose = _cam_pose(extrinsic, dev)
    R = pose[:3, :3]
    xyz = _camera_xyz(d, *_intrinsics(intrinsic, dev))
    pts = xyz.reshape(-1, 3) @ R.T + pose[:3, 3]
    cols = c.reshape(-1, c.shape[-1])
    valid = ((d > 0.0) & torch.isfinite(d)).reshape(-1)
    nrm = None
    if compute_normals:
        dx = torch.diff(xyz, dim=1, append=xyz[:, -1:, :])
        dy = torch.diff(xyz, dim=0, append=xyz[-1:, :, :])
        nrm = torch.linalg.cross(dy, dx, dim=-1).reshape(-1, 3) @ R.T
        norm = torch.linalg.norm(nrm, dim=-1, keepdim=True)
        up = torch.tensor([0.0, 0.0, 1.0], device=dev)
        nrm = torch.where(norm > 1e-12, nrm / norm.clamp(min=1e-12), up)
    pcd = PointCloud(device=dev)
    if project_valid_depth_only:
        pcd.points = pts[valid]
        pcd.colors = cols[valid]
        if compute_normals:
            pcd.normals = nrm[valid]
    else:
        pcd.points = torch.where(valid[:, None], pts, float("nan"))
        pcd.colors = cols
        if compute_normals:
            pcd.normals = nrm
    return pcd


def create_from_disparity(disp, color, left_intrinsic, right_intrinsic,
                          baseline: float, device=None):
    """cupoch PointCloud::CreateFromDisparity: OpenCV-style Q-matrix
    reprojection of the pixels with a positive disparity and a finite
    point; colours scaled from uint8 (or uint16) to [0, 1]."""
    from .pointcloud import PointCloud

    d = _image_tensor(disp, device)
    dev = d.device
    if d.ndim == 3:
        d = d[..., 0]
    c = _image_tensor(color, dev).to(dev)
    if c.ndim == 2:
        c = c[..., None].expand(-1, -1, 3)
    if c.ndim == 3 and c.shape[-1] == 1:
        c = c.expand(-1, -1, 3)
    if d.shape[:2] != c.shape[:2]:
        console.log_error("[PointCloud::CreateFromDisparity] Unsupported "
                          "image format.")
    tx = -float(baseline)
    fxl, fyl = left_intrinsic.get_focal_length()
    cxl, cyl = left_intrinsic.get_principal_point()
    cxr, _ = right_intrinsic.get_principal_point()
    Q = np.zeros((4, 4), np.float32)
    Q[0, 0] = fyl * tx
    Q[0, 3] = -fyl * cxl * tx
    Q[1, 1] = fxl * tx
    Q[1, 3] = -fxl * cyl * tx
    Q[2, 3] = fxl * fyl * tx
    Q[3, 2] = -fyl
    Q[3, 3] = fyl * (cxl - cxr)
    scale = 65535.0 if c.dtype == torch.uint16 else 255.0
    Q = torch.as_tensor(Q, device=dev)
    d = d.to(torch.float32)
    H, W = d.shape
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    px = (Q[0, 0] * u + Q[0, 3]).expand(H, W)
    py = (Q[1, 1] * v + Q[1, 3]).expand(H, W)
    pz = Q[2, 3].expand(H, W)
    inv_w = 1.0 / (Q[3, 2] * d + Q[3, 3])
    pts = torch.stack([px * inv_w, py * inv_w, pz * inv_w], -1) \
        .reshape(-1, 3)
    cols = (c.to(torch.float32) / _f32(scale, dev)).reshape(-1, 3)
    keep = (d > 0).reshape(-1) & torch.isfinite(pts).all(-1)
    pcd = PointCloud(pts[keep], device=dev)
    pcd.colors = cols[keep]
    return pcd


def create_from_laserscanbuffer(scan, min_range: float, max_range: float):
    """The buffer's readings within [min_range, max_range] as world
    points, grey colours from the intensities when it has them (cupoch
    PointCloud::CreateFromLaserScanBuffer, pointcloud_factory.cu:375-416);
    on the buffer's device."""
    from .laserscanbuffer import scan_to_points
    from .pointcloud import PointCloud

    if scan.is_empty():
        console.log_error("[PointCloud::CreateFromLaserScanBuffer] Empty "
                          "scan, return empty pointcloud.")
    if min_range >= max_range:
        console.log_error("[PointCloud::CreateFromLaserScanBuffer] "
                          "min_range must be smaller than max_range.")
    pts, ok = scan_to_points(scan.ranges, scan.origins, scan.min_angle_,
                             scan.get_angle_increment(), min_range,
                             max_range)
    keep = ok & scan._slot_mask().repeat_interleave(scan.num_steps_)
    pcd = PointCloud(pts[keep], device=scan.device)
    if scan.has_intensities():
        pcd.colors = scan.intensities.reshape(-1)[keep][:, None].expand(
            -1, 3).contiguous()
    return pcd


def create_from_occupancygrid(occgrid):
    """The occupied voxels' centres (cupoch
    PointCloud::CreateFromOccupancyGrid, pointcloud_factory.cu:418-430);
    on the grid's device."""
    from .pointcloud import PointCloud

    idx, _, _ = occgrid.extract_occupied_voxels()
    return PointCloud(occgrid.voxel_centers(idx), device=occgrid.device)


# the JAX package's name of the same factory
create_from_occupancy_grid = create_from_occupancygrid
