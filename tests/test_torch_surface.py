"""The port's public surface against the JAX package's: every JAX
module has a counterpart of the same path in cupoch_tpu_torch, every
public module-level name of it has a counterpart there (but for a short
list of internals that moved, each with its reason), every
subpackage's exported names are the JAX package's (`utility`'s with
`is_tpu_available` replaced by `is_cuda_available`)."""
import importlib
import inspect
import pkgutil

import pytest

import cupoch_tpu

# (JAX module below the package, name): where the port keeps it, and why
MOVED = {
    ("knn.rungrid", "fused_query"):
        "kernel 2's wrapper, in knn/rungrid_fused.py beside its CUDA source",
    ("knn.rungrid", "query_nn_rungrid"):
        "kernel 2's correspondence mode, in knn/rungrid_fused.py",
    ("knn.rungrid", "gmm_moments"):
        "kernel 3's wrapper, in knn/rungrid_gmm.py beside its CUDA source",
    ("knn.poolgrid", "SLOT_BITS"):
        "kernel 1's key packing, in knn/poolgrid_slot.py (SLOT_MASK)",
    ("knn.poolgrid", "SLOT_MASK"):
        "kernel 1's key packing, in knn/poolgrid_slot.py",
    ("knn.poolgrid", "query_channels"):
        "the pooled row's channel count, computed in bin_queries_pool",
    ("odometry.odometry_core", "jnp_filter_gaussian3"):
        "the [H, W] filters drop the jnp_ prefix (filter_gaussian3)",
    ("odometry.odometry_core", "jnp_filter_sobel_dx"):
        "the [H, W] filters drop the jnp_ prefix (filter_sobel_dx)",
    ("odometry.odometry_core", "jnp_filter_sobel_dy"):
        "the [H, W] filters drop the jnp_ prefix (filter_sobel_dy)",
    ("odometry.odometry_core", "jnp_downsample2"):
        "the [H, W] filters drop the jnp_ prefix (downsample2)",
    ("registration.estimation", "UPDATE_FNS"):
        "the loops dispatch on the estimator's type in normal_system",
    ("geometry.geometry", "asarray_f32"):
        "as_f32, which takes the device to put the array on",
    ("utility", "is_tpu_available"):
        "is_cuda_available, the port's device query",
}
# JAX modules with no module of the same path in the port
NO_MODULE = {
    "native": "the LZF codec: utility/lzf.py and csrc/lzf.c",
    "native._liblzf": "the LZF codec: utility/lzf.py and csrc/lzf.c",
}


def _jax_modules():
    out = []
    for m in pkgutil.walk_packages(cupoch_tpu.__path__, "cupoch_tpu."):
        rel = m.name[len("cupoch_tpu."):]
        if rel.endswith("__main__"):   # runs the harness when imported
            continue
        out.append(rel)
    return out


def _exports(mod) -> set:
    """A package `__init__`'s names: its `__all__`, else every public
    name it binds that is not a module."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def _public(mod) -> set:
    """Public module-level names: what the module defines or exports in
    `__all__`, and its plain constants; not the modules, classes and
    functions it imports from elsewhere."""
    names = set()
    exported = set(getattr(mod, "__all__", ()))
    for n, v in vars(mod).items():
        if n.startswith("_") or inspect.ismodule(v):
            continue
        owner = getattr(v, "__module__", None)
        if n in exported or owner in (None, mod.__name__) \
                or isinstance(v, (bool, int, float, str, tuple)):
            names.add(n)
    return names


def test_torch_every_jax_module_name_has_a_counterpart():
    missing, moved_seen = [], set()
    mods = _jax_modules()
    assert len(mods) >= 90, mods
    for rel in mods:
        if rel in NO_MODULE:
            continue
        jmod = importlib.import_module("cupoch_tpu." + rel)
        tmod = importlib.import_module("cupoch_tpu_torch." + rel)
        for n in sorted(_public(jmod)):
            if (rel, n) in MOVED:
                moved_seen.add((rel, n))
                assert not hasattr(tmod, n), (rel, n, "is listed as moved")
            elif not hasattr(tmod, n):
                missing.append(f"{rel}.{n}")
    assert not missing, missing
    assert moved_seen == set(MOVED), set(MOVED) - moved_seen


def _subpackages():
    return sorted(m.name[len("cupoch_tpu."):] for m in pkgutil.walk_packages(
        cupoch_tpu.__path__, "cupoch_tpu.") if m.ispkg
        and not m.name.startswith("cupoch_tpu.native"))


@pytest.mark.parametrize("rel", _subpackages())
def test_torch_subpackage_exports_match_jax(rel):
    jmod = importlib.import_module("cupoch_tpu." + rel)
    tmod = importlib.import_module("cupoch_tpu_torch." + rel)
    want = _exports(jmod)
    if rel == "utility":
        want = want - {"is_tpu_available"} | {"is_cuda_available"}
    assert want <= set(dir(tmod)), want - set(dir(tmod))

