"""Nested dicts of tensors <-> one contiguous f32 host buffer.

The port keeps the JAX package's parameter tree (nested dicts, block weights
stacked on a leading layer axis), and flattens it the way ``jax.tree_util``
flattens dicts: keys in sorted order, depth first. The buffer layout and the
``TensorSpec`` list therefore match ``distributedvolunteercomputing_tpu``'s
``utils/pytree.py`` leaf for leaf, which is what the averaging tier hashes
and ships. Dtype names are numpy's (``"float32"``), with ``"bfloat16"`` for
bf16 as ml_dtypes names it on the JAX side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

# A tree definition: None for a leaf, else (sorted keys, child definitions).
TreeDef = Union[None, Tuple[Tuple[str, ...], Tuple[Any, ...]]]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype of one leaf inside a flattened buffer."""

    shape: Tuple[int, ...]
    dtype: str  # numpy dtype name of the ORIGINAL leaf (restored on unflatten)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree_util`` order (sorted dict keys, depth first)."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves: List[Any] = []
        defs = []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves.extend(sub)
            defs.append(d)
        return leaves, (keys, tuple(defs))
    return [tree], None


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)

    def build(d: TreeDef) -> Any:
        if d is None:
            return next(it)
        keys, defs = d
        return {k: build(sd) for k, sd in zip(keys, defs)}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _host_f32(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        # Widen on the device first: numpy has no bf16.
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def tree_specs(tree: Any) -> Tuple[List[TensorSpec], TreeDef]:
    """(specs, treedef) without materializing the flat buffer."""
    leaves, treedef = tree_flatten(tree)
    specs = [TensorSpec(tuple(int(d) for d in x.shape), dtype_name(x.dtype)) for x in leaves]
    return specs, treedef


def flatten_to_buffer(tree: Any) -> Tuple[np.ndarray, List[TensorSpec], TreeDef]:
    """One contiguous float32 host buffer, the leaves' specs, and the treedef."""
    specs, treedef = tree_specs(tree)
    leaves = tree_leaves(tree)
    if not leaves:
        return np.zeros((0,), np.float32), [], treedef
    buf = np.concatenate([_host_f32(x).ravel() for x in leaves])
    return buf, specs, treedef


def unflatten_from_buffer(
    buf: np.ndarray,
    specs: Sequence[TensorSpec],
    treedef: TreeDef,
    device: Union[str, torch.device, None] = "cpu",
) -> Any:
    """Inverse of :func:`flatten_to_buffer` (restores shapes and dtypes).

    ``device=None`` returns host numpy leaves, the averager's contract
    (AveragerFn takes and returns host trees). numpy has no bf16, so bf16
    leaves come back as float32 there; the trainer casts on the device."""
    leaves = []
    offset = 0
    for spec in specs:
        n = spec.size
        chunk = np.ascontiguousarray(buf[offset : offset + n], np.float32).reshape(spec.shape)
        if device is None:
            # A copy, as the reference's astype makes: the leaves never alias
            # the averager's buffer.
            leaves.append(chunk.astype(np.float32 if spec.dtype == "bfloat16" else spec.dtype))
        else:
            leaves.append(torch.from_numpy(chunk).to(device=device, dtype=torch_dtype(spec.dtype)))
        offset += n
    if offset != buf.size:
        raise ValueError(f"buffer size {buf.size} != specs total {offset}")
    return tree_unflatten(treedef, leaves)


def cast_floating(tree: Any, dtype: Union[str, torch.dtype]) -> Any:
    """Cast every FLOATING leaf to ``dtype``; integer leaves keep theirs."""
    dt = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, tree)
