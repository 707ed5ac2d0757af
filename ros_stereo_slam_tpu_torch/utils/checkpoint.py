"""Checkpoint / resume of the full SLAM state.

Port of ``ros_stereo_slam_tpu/utils/checkpoint.py`` for the port's trees:
NamedTuples, dicts (string keys), tuples and lists whose leaves are
tensors or plain values (int, float, bool, str, None).  Tensors go into
one ``.npz``, bf16 ones as float32 (an exact upcast, since numpy has no
bf16); plain values, such as the carry's ``key`` and ``frame_idx``, go
into the JSON that describes the tree, stored in the same file.  Loading
restores each tensor to the template's device and dtype, and raises if
the structure or a shape differs from the template's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_PLAIN = (bool, int, float, str, type(None))


def _spec(tree, leaves: list):
    """The JSON description of `tree`; its tensors are appended to `leaves`
    in traversal order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"tensor": list(tree.shape)}
    if isinstance(tree, _PLAIN):
        return {"value": tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"namedtuple": type(tree).__name__,
                "fields": {f: _spec(getattr(tree, f), leaves) for f in tree._fields}}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_spec(x, leaves) for x in tree]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint dict keys must be strings")
        return {"dict": {k: _spec(v, leaves) for k, v in tree.items()}}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _skeleton(spec):
    """`spec` without shapes and values: what two trees must share."""
    if "tensor" in spec:
        return "tensor"
    if "value" in spec:
        return "value"
    if "namedtuple" in spec:
        return [spec["namedtuple"], {f: _skeleton(s) for f, s in spec["fields"].items()}]
    (kind, body), = spec.items()
    if kind == "dict":
        return ["dict", {k: _skeleton(s) for k, s in body.items()}]
    return [kind, [_skeleton(s) for s in body]]


def _npz_safe(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    """Serialize `tree` and JSON metadata `meta` to one ``.npz``."""
    leaves: list = []
    spec = _spec(tree, leaves)
    arrs = {f"leaf_{i}": _npz_safe(t) for i, t in enumerate(leaves)}
    arrs["__tree__"] = np.frombuffer(json.dumps(spec).encode(), dtype=np.uint8)
    arrs["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrs)


def _build(like, spec, z, counter: list):
    if isinstance(like, torch.Tensor):
        i = counter[0]
        counter[0] += 1
        a = z[f"leaf_{i}"]
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {i} shape {a.shape} != template "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(a).to(like.device).to(like.dtype)
    if "value" in spec:
        return spec["value"]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_build(getattr(like, f), spec["fields"][f], z, counter)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _build(v, spec["dict"][k], z, counter) for k, v in like.items()}
    (body,) = spec.values()
    return type(like)(_build(x, s, z, counter) for x, s in zip(like, body))


def load_pytree(path: str, like):
    """Restore a tree saved by :func:`save_pytree` in the structure of
    `like` (its tensors give each leaf's device and dtype).  Returns
    (tree, meta)."""
    with np.load(path) as z:
        spec = json.loads(z["__tree__"].tobytes().decode())
        meta = json.loads(z["__meta__"].tobytes().decode() or "{}")
        if _skeleton(spec) != _skeleton(_spec(like, [])):
            raise ValueError("checkpoint structure does not match template")
        return _build(like, spec, z, [0]), meta
