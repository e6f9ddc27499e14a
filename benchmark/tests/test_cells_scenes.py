"""Generators: the same seed and frame give the same inputs, other
frames and seeds other inputs, every frame the same amount of work."""
import numpy as np
import torch

from benchmark.lib import registry, rng
from benchmark.scenes import room
from benchmark.scenes.rgbd_room import RGBDRoom

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def test_room_fragments():
    def frag(seed, k):
        g = rng.generator(CPU, seed, "room", "window", k)
        return room.fragment(g, 5000, 0.002, 0.005)
    a, b, c, d = frag(SEED, 0), frag(SEED, 0), frag(SEED, 1), frag(7, 0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    assert a[0].shape == c[0].shape == (5000, 3)
    assert torch.allclose(a[1].norm(dim=1), torch.ones(5000,
                                                       dtype=torch.float64))
    assert room.part_counts(5000, 0.005) == room.part_counts(5000, 0.005)
    g = rng.generator(CPU, SEED, "m")
    M = room.random_motion(g, 1.0, 0.01, room.motion_sizes((0.3, 0.9), 5))
    R = M[:3, :3]
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64))
    angle = torch.arccos(((torch.trace(R) - 1) / 2).clamp(-1, 1))
    assert float(angle) <= np.radians(1.0) + 1e-9
    # any 20 consecutive frames spread their turns over [0, 1)
    turns = sorted(room.motion_sizes((0.77, 0.1), k)[0]
                   for k in range(40, 60))
    assert max(b - a for a, b in zip([0.0] + turns, turns + [1.0])) < 0.1


def test_rgbd_frames():
    cfg = registry.config(registry.load_benchmark(), "rgbd640")
    cam = dict(cfg["camera"], width=80, height=60, fx=65.625, fy=65.625,
               cx=39.5625, cy=29.5625)
    t = registry.traffic("odometry")
    scene = RGBDRoom(cam, cfg["depth_scale"], t, 5, CPU)
    a = scene.render(2, rng.generator(CPU, SEED, "rgbd", 2))
    b = scene.render(2, rng.generator(CPU, SEED, "rgbd", 2))
    c = scene.render(3, rng.generator(CPU, SEED, "rgbd", 3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert a[0].dtype == torch.uint8 and a[1].dtype == torch.uint16
    mm = a[1].to(torch.int32)
    assert 0.9 < float((mm > 0).float().mean()) and int(mm.max()) < 4000
    # the sweep turns back: positions stay within [0, sweep_frames]
    pos = [scene.position(k) for k in range(200)]
    assert min(pos) == 0 and max(pos) == t["sweep_frames"]


def test_street_scans():
    from benchmark.scenes import street
    p = dict(registry.traffic("street_scans"), beams=8, azimuth_steps=256)
    for variant in ("street", "blocks"):
        q = dict(p, **p["variants"][variant])
        boxes = street.layout(rng.host_rng(SEED, variant), q)
        again = street.layout(rng.host_rng(SEED, variant), q)
        assert np.array_equal(boxes, again)
        assert (boxes[:, 3:] > boxes[:, :3]).all()
        T = street.pose(1.0, 0.5, 2.0, q["sensor_height_m"])
        a = street.scan(boxes, T, q, rng.generator(CPU, SEED, "scan", 0))
        b = street.scan(boxes, T, q, rng.generator(CPU, SEED, "scan", 0))
        c = street.scan(boxes, T, q, rng.generator(CPU, SEED, "scan", 1))
        assert torch.equal(a, b) and not torch.equal(a, c)
        r = a.double().norm(dim=1)
        assert 0.5 * q["beams"] * q["azimuth_steps"] < a.shape[0] \
            <= q["beams"] * q["azimuth_steps"]
        assert float(r.max()) <= q["max_range_m"] + 0.1
        # nothing lies below the ground
        assert float(a[:, 2].min()) > -q["sensor_height_m"] - 0.1


def test_lidar_witness_runs(capsys):
    """The LiDAR witness at 8 beams on the host: one line a reading,
    and the port's ICP given the reference's normals lands on the
    reference's pose."""
    import json

    from benchmark import lidar_witness
    lidar_witness.main(["--seeds", str(SEED), "--device", "cpu",
                        "--beams", "8"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["variant"] for x in lines] == ["street", "blocks"]
    street_reading = lines[0]
    assert street_reading["program_ref_normals"]["shift_gap"] < 1e-4
    assert street_reading["reference_port_normals"]["shift_gap"] < 1e-4
