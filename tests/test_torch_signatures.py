"""The port's public surface against the JAX package's.

Every public function and class that a module of ``ros_stereo_slam_tpu``
defines must exist in the port's module of the same path, and every
keyword it takes (a function's parameters, a class's ``__init__``
parameters or NamedTuple/dataclass fields) must be a keyword of the
port's counterpart; every public attribute that a JAX class sets on
``self`` must be readable on the port's class.  What the port leaves out
on purpose is listed below, each with its reason.
"""

import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "ros_stereo_slam_tpu", "ros_stereo_slam_tpu_torch"

# Modules without a counterpart: the three Pallas kernels, which the CUDA
# sources in csrc/ replace (ops/lk_cuda.py, ops/orb_cuda.py, ops/vocab_cuda.py).
NO_MODULE = {
    "ops/lk_pallas.py": "Pallas kernel K1/K1b; csrc/lk_level.cu",
    "ops/orb_pallas.py": "Pallas kernel K2/K2b; csrc/orb_desc.cu",
    "ops/vocab_pallas.py": "Pallas kernel K3; csrc/vocab_descend.cu",
}

# Public names without a counterpart.
NO_NAME = {
    ("models/vocab.py", "prepare_centers_for_scan"):
        "tail-pads the int8 tables to the TPU tile; the port descends a packed tree",
    ("parallel/mesh.py", "AXIS"): "a one-axis torch.distributed group has no axis name",
    ("parallel/mesh.py", "replicated"): "a NamedSharding; torch tensors have no sharding",
    ("parallel/mesh.py", "sharded_leading"): "a NamedSharding; torch tensors have no sharding",
    ("utils/profiling.py", "StageTimer"): "the port's spans replace it: `span` times a stage, "
                                          "`summary`/`dump` give its totals",
}

# Keywords the port does not take: (module, name) -> {keyword: reason}.
_TPU = "TPU mechanics: Pallas backend selection"
_AXIS = "a one-axis torch.distributed group has no axis name; `mesh` carries the group"
_GEN = "a JAX PRNG key; the port takes a torch.Generator, `gen`, in its place"
NO_KEYWORD = {
    ("ops/lk.py", "LKParams"): {"backend": _TPU, "select_dtype": "TPU mechanics: the bf16 "
                                "select of the Pallas kernel (H5); the port is the f32 variant"},
    ("ops/orb.py", "detect_and_compute"): {"backend": _TPU},
    ("ops/fast.py", "top_corners"): {"exact": "the port is the exact variant (H4)"},
    ("models/bundle_adjust.py", "ba_solve"): {
        "cg_iters": "the port solves the reduced system directly (D1)", "axis_name": _AXIS},
    ("models/pose_graph.py", "optimize"): {
        "odo_idx": "`mesh` carries the layout of the chain", "axis_name": _AXIS},
    ("parallel/mesh.py", "make_mesh"): {"axis_name": _AXIS},
    ("parallel/dist_map.py", "keyframe_shardings"): {"axis_name": _AXIS},
    ("parallel/dist_map.py", "shard_keyframes"): {"axis_name": _AXIS},
    ("parallel/dist_map.py", "rewrite_points_sharded"): {
        "mesh": "each rank rewrites its own blocks with the single-device function: "
                "no collective, so no group", "axis_name": _AXIS},
    ("models/slam_scan.py", "run_sequence_slam"): {
        "centers": "the port's descent (K3) reads the packed tree, `tree`"},
    ("models/slam_scan.py", "run_sequence_slam_batched"): {
        "centers": "the port's descent (K3) reads the packed tree, `tree`"},
    ("models/frontend.py", "odometry_step"): {"key": _GEN},
    ("models/frontend.py", "stereo_bootstrap"): {"key": _GEN},
    ("ops/pnp.py", "pnp_ransac"): {"key": _GEN},
    ("ops/ransac.py", "fmat_ransac"): {"key": _GEN},
    ("ops/essential.py", "essential_ransac"): {"key": _GEN},
    ("ops/essential.py", "monocular_triangulate"): {"key": _GEN},
}

MODULES = sorted(str(p.relative_to(ROOT / JAX_PKG)) for p in (ROOT / JAX_PKG).rglob("*.py"))


def _module_name(pkg: str, rel: str) -> str:
    parts = [pkg, *rel[:-3].split("/")]
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _own_public(mod) -> dict:
    """Public functions and classes defined in `mod` itself."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o)
                                          or callable(getattr(o, "__wrapped__", None)))
            and getattr(o, "__module__", None) == mod.__name__}


def _keywords(obj) -> set:
    if inspect.isclass(obj) and hasattr(obj, "_fields"):
        return set(obj._fields)
    return {n for n in inspect.signature(obj).parameters if n not in ("self", "cls")}


def _self_attributes(path: pathlib.Path, cls: str) -> set:
    """Public attributes that the methods of class `cls` assign on self."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "self"
            and not n.attr.startswith("_")}


def test_exclusions_name_real_gaps():
    """Every exclusion names a JAX module, name or keyword that exists."""
    for rel in NO_MODULE:
        assert (ROOT / JAX_PKG / rel).exists(), rel
    for rel, name in list(NO_NAME) + list(NO_KEYWORD):
        assert hasattr(importlib.import_module(_module_name(JAX_PKG, rel)), name), (rel, name)
    for (rel, name), kws in NO_KEYWORD.items():
        theirs = _keywords(getattr(importlib.import_module(_module_name(JAX_PKG, rel)), name))
        assert set(kws) <= theirs, (rel, name, set(kws) - theirs)


@pytest.mark.parametrize("rel", MODULES)
def test_port_takes_every_public_keyword(rel):
    if rel in NO_MODULE:
        assert not (ROOT / PORT_PKG / rel).exists()
        return
    jax_mod = importlib.import_module(_module_name(JAX_PKG, rel))
    port_mod = importlib.import_module(_module_name(PORT_PKG, rel))
    missing = []
    for name, obj in _own_public(jax_mod).items():
        if (rel, name) in NO_NAME:
            continue
        ours = getattr(port_mod, name, None)
        if ours is None:
            missing.append(f"{name}: no counterpart")
            continue
        excluded = NO_KEYWORD.get((rel, name), {})
        for kw in sorted(_keywords(obj) - _keywords(ours) - set(excluded)):
            missing.append(f"{name}({kw}=)")
        if inspect.isclass(obj) and not hasattr(obj, "_fields"):
            # attributes a port instance holds: its own self-assignments,
            # class attributes and properties, and its fields
            have = (_self_attributes(ROOT / PORT_PKG / rel, name) if ours.__module__ ==
                    port_mod.__name__ else set()) | set(dir(ours)) | _keywords(ours)
            for attr in sorted(_self_attributes(ROOT / JAX_PKG / rel, name) - have):
                missing.append(f"{name}.{attr}")
    assert not missing, f"{rel}: the port lacks {missing}"
