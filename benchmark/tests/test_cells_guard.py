"""The no-JAX check compares whole top-level module names."""
from benchmark.lib import guard


def test_forbidden_by_whole_top_level_name():
    mods = {"cupoch_tpu_torch": 0, "cupoch_tpu_torch.knn": 0,
            "jaxtyping": 0, "flaxen": 0, "torch": 0}
    assert guard.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "cupoch_tpu", "cupoch_tpu.knn.poolgrid"):
        assert guard.forbidden_modules(dict(mods, **{bad: 0})) == \
            [bad.split(".")[0]]


def test_this_process_loads_no_jax():
    import benchmark.run  # noqa: F401
    import benchmark.drivers.odometry  # noqa: F401
    import benchmark.drivers.scan_icp  # noqa: F401
    assert guard.forbidden_modules() == []
