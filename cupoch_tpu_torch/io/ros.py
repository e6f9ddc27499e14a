"""ROS message codecs without a ROS dependency (cupoch
io/ros/pointcloud_msg.{h,cu}, pointcloud_msg.h:28-108, and
image_msg.{h,cu}): raw-byte sensor_msgs/PointCloud2 and sensor_msgs/
Image converters driven by field descriptors, so rospy / rclpy callers
pass `msg.data` directly. Decoders put the result on `device` (None:
the card); encoders take geometry on any device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..geometry.image import Image
from ..geometry.pointcloud import PointCloud
from ..utility import console
from .pointcloud_io import to_numpy


class PointField:
    """cupoch pointcloud_msg.h:28-44 (sensor_msgs/PointField)."""

    INT8 = 1
    UINT8 = 2
    INT16 = 3
    UINT16 = 4
    INT32 = 5
    UINT32 = 6
    FLOAT32 = 7
    FLOAT64 = 8

    _NP = {INT8: "i1", UINT8: "u1", INT16: "i2", UINT16: "u2",
           INT32: "i4", UINT32: "u4", FLOAT32: "f4", FLOAT64: "f8"}

    def __init__(self, name: str, offset: int, datatype: int,
                 count: int = 1):
        self.name = name
        self.offset = int(offset)
        self.datatype = int(datatype)
        self.count = int(count)


class PointCloud2MsgInfo:
    """cupoch pointcloud_msg.h:46-78."""

    def __init__(self, width: int, height: int, fields: List[PointField],
                 is_bigendian: bool = False, point_step: int = 16,
                 row_step: int = 0, is_dense: bool = False):
        self.width = int(width)
        self.height = int(height)
        self.fields = fields
        self.is_bigendian = bool(is_bigendian)
        self.point_step = int(point_step)
        self.row_step = int(row_step) or self.point_step * self.width
        self.is_dense = bool(is_dense)

    @staticmethod
    def default(width: int, point_step: int = 16) -> "PointCloud2MsgInfo":
        """xyz float32 layout (pointcloud_msg.h Default)."""
        return PointCloud2MsgInfo(
            width, 1,
            [PointField("x", 0, PointField.FLOAT32),
             PointField("y", 4, PointField.FLOAT32),
             PointField("z", 8, PointField.FLOAT32)],
            point_step=point_step)

    @staticmethod
    def default_dense_color(width: int, height: int = 1,
                            point_step: int = 32) -> "PointCloud2MsgInfo":
        return PointCloud2MsgInfo(
            width, height,
            [PointField("x", 0, PointField.FLOAT32),
             PointField("y", 4, PointField.FLOAT32),
             PointField("z", 8, PointField.FLOAT32),
             PointField("rgb", 16, PointField.FLOAT32)],
            point_step=point_step, is_dense=True)


def _field(info: PointCloud2MsgInfo, name: str) -> Optional[PointField]:
    for f in info.fields:
        if f.name == name:
            return f
    return None


def _extract(data: np.ndarray, info: PointCloud2MsgInfo,
             f: PointField) -> np.ndarray:
    endian = ">" if info.is_bigendian else "<"
    dt = np.dtype(endian + PointField._NP[f.datatype])
    n = info.width * info.height
    rows = data.reshape(n, info.point_step)
    raw = np.ascontiguousarray(
        rows[:, f.offset:f.offset + dt.itemsize]).view(dt)[:, 0]
    return raw


def create_from_pointcloud2_msg(data: bytes, info: PointCloud2MsgInfo,
                                device=None) -> PointCloud:
    """bytes -> PointCloud (cupoch CreateFromPointCloud2Msg,
    pointcloud_msg.cu); points that are not finite are dropped."""
    buf = np.frombuffer(data, np.uint8)[:info.height * info.row_step]
    n = info.width * info.height
    buf = buf.reshape(info.height, info.row_step)[
        :, :info.width * info.point_step].reshape(-1)
    fx, fy, fz = (_field(info, k) for k in ("x", "y", "z"))
    if fx is None or fy is None or fz is None:
        console.log_error("[PointCloud2Msg] missing x/y/z fields.")
    pts = np.stack([_extract(buf, info, f).astype(np.float32)
                    for f in (fx, fy, fz)], -1)
    frgb = _field(info, "rgb")
    ok = np.isfinite(pts).all(-1)
    pcd = PointCloud(pts[ok], device=device)
    if frgb is not None:
        rgbf = _extract(buf, info, frgb)
        rgb = np.ascontiguousarray(rgbf.astype(np.float32)).view(np.uint32)
        cols = np.stack([(rgb >> 16) & 0xFF, (rgb >> 8) & 0xFF, rgb & 0xFF],
                        -1).astype(np.float32) / 255.0
        pcd.colors = cols[ok]
    return pcd


def create_to_pointcloud2_msg(pcd, info: Optional[PointCloud2MsgInfo] = None
                              ) -> tuple:
    """PointCloud -> (bytes, info) (cupoch CreateToPointCloud2Msg)."""
    n = len(pcd)
    if info is None:
        info = (PointCloud2MsgInfo.default_dense_color(n)
                if pcd.has_colors() else PointCloud2MsgInfo.default(n))
    out = np.zeros((n, info.point_step), np.uint8)
    pts = to_numpy(pcd.points, np.float32)
    for f, col in zip((_field(info, "x"), _field(info, "y"),
                       _field(info, "z")), range(3)):
        out[:, f.offset:f.offset + 4] = np.ascontiguousarray(
            pts[:, col]).view(np.uint8).reshape(n, 4)
    frgb = _field(info, "rgb")
    if frgb is not None and pcd.has_colors():
        c = np.clip(to_numpy(pcd.colors) * 255.0, 0,
                    255).astype(np.uint32)
        packed = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]).view(np.float32)
        out[:, frgb.offset:frgb.offset + 4] = np.ascontiguousarray(
            packed).view(np.uint8).reshape(n, 4)
    return out.tobytes(), info


class ImageMsgInfo:
    """cupoch image_msg.h (sensor_msgs/Image descriptor)."""

    def __init__(self, width: int, height: int, encoding: str = "rgb8",
                 is_bigendian: bool = False, step: int = 0):
        self.width = int(width)
        self.height = int(height)
        self.encoding = encoding
        self.is_bigendian = bool(is_bigendian)
        ch = {"rgb8": 3, "bgr8": 3, "mono8": 1, "mono16": 1,
              "16UC1": 1}.get(encoding, 3)
        bpc = 2 if encoding in ("mono16", "16UC1") else 1
        self.step = int(step) or self.width * ch * bpc
        self.channels = ch
        self.bytes_per_channel = bpc

    @staticmethod
    def default(width: int, height: int) -> "ImageMsgInfo":
        return ImageMsgInfo(width, height, "rgb8")


def create_from_image_msg(data: bytes, info: ImageMsgInfo,
                          device=None) -> Image:
    dt = np.uint16 if info.bytes_per_channel == 2 else np.uint8
    arr = np.frombuffer(data, dt).reshape(
        info.height, info.step // (info.channels * info.bytes_per_channel),
        info.channels)[:, :info.width]
    if info.encoding == "bgr8":
        arr = arr[..., ::-1]
    return Image(np.ascontiguousarray(arr), device=device)


def create_to_image_msg(image, info: Optional[ImageMsgInfo] = None) -> tuple:
    arr = image.to_numpy()
    if info is None:
        enc = ("mono16" if arr.dtype == np.uint16 else
               "mono8" if arr.shape[-1] == 1 else "rgb8")
        info = ImageMsgInfo(arr.shape[1], arr.shape[0], enc)
    out = arr
    if info.encoding == "bgr8":
        out = out[..., ::-1]
    return np.ascontiguousarray(out).tobytes(), info
