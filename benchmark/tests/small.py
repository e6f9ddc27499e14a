"""Small sizes of every cell for the CPU tests: the same code paths
(the ICP cells below the port's grid threshold), a few frames, and the
limits of the compared numbers at these sizes, set between the sound
readings and the bfloat16 control's on the CPU (PERF.md gives both)."""
ROOM = {"points": 12000, "threshold_m": 0.05, "warm_frames": 1,
        "checked_frames": 2,
        "limits": {"rot_gap": 1e-4, "shift_gap": 2e-4, "fitness_gap": 5e-4,
                   "rmse_gap": 1e-3}}
ODOMETRY = {"warm_frames": 1, "checked_frames": 2,
            "limits": {"rot_gap": 2e-3, "shift_gap": 5e-3}}
CAMERA = {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
          "cx": 39.5625, "cy": 29.5625}
# (traffic, configuration) overrides
CELLS = {
    "scan_icp.room1m": (ROOM, {}),
    "scan_icp.room500k": (ROOM, {}),
    "rgbd640.odometry": (ODOMETRY, {"camera": CAMERA}),
}
SECONDS = 0.01                 # a window of one frame
SEED = 2 ** 31 + 4321
