"""Parameter partition rules and the placement of one leaf over the mesh
(ported from ``distributedvolunteercomputing_tpu/parallel/sharding.py``).

The rule table is the reference's: Megatron-style tensor parallelism by the
leaf's path in the parameter tree.

- column-parallel (the OUTPUT feature dim over ``tp``): qkv / wq / wk / wv,
  mlp_in / w_gate / w_up, and lm_head;
- row-parallel (the INPUT feature dim over ``tp``): attn_out / wo / mlp_out /
  w_down;
- MoE expert stacks: experts over ``ep``, each expert's hidden dim over
  ``tp``;
- everything else (embeddings, norms, the biases of row-parallel layers,
  LoRA adapters) is replicated.

A rule applies only where the mesh axis divides the dim; otherwise that dim
falls back to replicated (GPT-2's vocab 50257 is prime: the tied embedding
stays replicated on any mesh). With a ``pp`` axis the stacked layer axis is
sharded over it (the rules are data here; the pipeline step is not ported).

The port's spec is ``PartitionSpec``, a tuple of axis names or None per dim
(it compares equal to the reference's). ``Sharded`` places one leaf over the
port's ``Mesh``: each rank holds exactly its slice as the spec assigns it,
and a leaf replicated over an axis is a full copy on each rank of that axis.
``Sharded.shard`` cuts a full tensor (or numpy array) into the per-rank
slices, ``Sharded.assemble`` puts them back together bit for bit.
``ShardedTensor`` is a live leaf: its placement and its per-rank tensors.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.parallel.mesh import Mesh, mesh_shape
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_unflatten


class PartitionSpec(tuple):
    """Axis name (or None) per dim, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: Optional[str]) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec

# (path regex, spec). First match wins; paths look like "blocks/qkv/w"
# (stacked scan-over-layers layout: leaves carry a leading n_layers axis).
# Specs are written for the TRAILING dims and right-aligned by _fit_spec, so
# one rule covers a stacked leaf and an unstacked one (lm_head).
_RULES: List[Tuple[str, PartitionSpec]] = [
    (r".*/(qkv|mlp_in)/w$", P(None, "tp")),
    (r".*/(qkv|mlp_in)/b$", P("tp")),
    (r".*/(attn_out|mlp_out)/w$", P("tp", None)),
    (r".*/(wq|wk|wv|w_gate|w_up)$", P(None, "tp")),
    (r".*/(wo|w_down)$", P("tp", None)),
    (r".*/lm_head$", P(None, "tp")),
    # MoE expert stacks [E, d, f] / [E, f, d]: experts over ep, per-expert
    # hidden dim over tp (column- then row-parallel, as for the dense FFN).
    (r".*/moe_in$", P("ep", None, "tp")),
    (r".*/moe_out$", P("ep", "tp", None)),
]


def _fit_spec(spec: Sequence[Optional[str]], shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    """RIGHT-align the spec to the leaf's rank (leading dims replicated) and
    drop axes that don't divide their dim."""
    axis_sizes = mesh_shape(mesh)
    pad = len(shape) - len(spec)
    out = []
    for dim in range(len(shape)):
        axis = spec[dim - pad] if dim >= pad else None
        if axis is not None and shape[dim] % axis_sizes.get(axis, 1) != 0:
            axis = None
        out.append(axis)
    return P(*out)


def is_stacked(path_str: str) -> bool:
    """A leaf under a stacked "blocks" subtree (leading layer axis)."""
    return "blocks/" in path_str and re.search(r"blocks/\d+(/|$)", path_str) is None


def partition_spec_for_path(path_str: str, shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    shape = tuple(int(d) for d in shape)
    spec = P()
    for pattern, rule_spec in _RULES:
        if re.match(pattern, "/" + path_str):
            spec = _fit_spec(rule_spec, shape, mesh)  # full rank after fit
            break
    # Pipeline parallelism: the layer axis of a stacked leaf over pp,
    # composed with the tp rules ([L, d_in, d_out] -> ("pp", None, "tp")).
    pp = mesh_shape(mesh).get("pp", 1)
    if pp > 1 and is_stacked(path_str) and shape and shape[0] % pp == 0:
        padded = list(spec) if len(spec) == len(shape) else [None] * len(shape)
        if padded[0] is None:
            padded[0] = "pp"
            spec = P(*padded)
    return spec


def leaf_paths(tree: Any) -> List[str]:
    """"a/b/c" per leaf, in the tree's (sorted-key) order."""
    if isinstance(tree, dict):
        return [f"{k}/{p}" if p else str(k) for k in sorted(tree) for p in leaf_paths(tree[k])]
    return [""]


def _map_with_path(fn, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, x) for p, x in zip(leaf_paths(tree), leaves)])


def make_param_shardings(mesh: Mesh, params: Any) -> Any:
    """Tree of ``Sharded`` matching ``params``, rules applied by path."""
    return _map_with_path(
        lambda path, x: Sharded(mesh, partition_spec_for_path(path, tuple(x.shape), mesh), tuple(x.shape)), params
    )


def _dp_sharded_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> PartitionSpec:
    spec = partition_spec_for_path(path, shape, mesh)
    padded = list(spec) + [None] * (len(shape) - len(spec))
    dp = mesh_shape(mesh).get("dp", 1)
    if dp > 1:
        for dim in range(len(shape)):
            if padded[dim] is None and shape[dim] % dp == 0:
                padded[dim] = "dp"
                break
    while padded and padded[-1] is None:  # P(None) and P() compare unequal
        padded.pop()
    return P(*padded)


def _dp_sharded_specs(mesh: Mesh, params: Any) -> Any:
    """Each leaf's rule spec plus ``dp`` on the first still-replicated dim the
    dp axis divides (leaves with no such dim keep their rule spec). The
    placement rule behind ZeRO-1 (optimizer moments) and FSDP (params)."""

    def assign(path: str, x: Any) -> "Sharded":
        shape = tuple(int(d) for d in x.shape)
        return Sharded(mesh, _dp_sharded_spec(path, shape, mesh), shape)

    return _map_with_path(assign, params)


def make_zero1_opt_shardings(mesh: Mesh, params: Any) -> Any:
    """ZeRO-1 placements for params-shaped optimizer moments: params stay
    replicated over dp, the moments are sharded over it, so each dp rank
    updates its slice of the params and the slices are gathered back."""
    return _dp_sharded_specs(mesh, params)


def make_fsdp_param_shardings(mesh: Mesh, params: Any) -> Any:
    """FSDP (ZeRO-3) placements: the params themselves dp-sharded by the same
    first-free-dim rule, so weights, grads and moments live at 1/dp per rank.
    The step gathers each layer's weights inside its checkpointed body and
    sends each gradient back to its owner's slice."""
    return _dp_sharded_specs(mesh, params)


def batch_sharding(mesh: Mesh, seq_axis: bool = False) -> "Sharded":
    """The batch's placement: leading dim over dp (and dim 1 over sp, which
    is not ported: ``put_batch`` refuses it)."""
    return Sharded(mesh, P("dp", "sp") if seq_axis else P("dp"), ())


# -- placement -----------------------------------------------------------------


class Sharded:
    """One leaf of ``shape`` placed over ``mesh`` by ``spec``; the reference's
    ``NamedSharding`` with the slicing written out. Ranks are ``mesh.flat()``
    order."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]], shape: Tuple[int, ...]):
        self.mesh = mesh
        self.spec = P(*spec)
        self.shape = tuple(int(d) for d in shape)
        self._sizes = mesh_shape(mesh)
        self._coords = [dict(zip(mesh.axis_names, c)) for c in np.ndindex(*mesh.devices.shape)]
        self.devices = mesh.flat()

    def __repr__(self) -> str:
        return f"Sharded({self.spec!r}, shape={self.shape})"

    def _axis(self, dim: int) -> Optional[str]:
        return self.spec[dim] if dim < len(self.spec) else None

    def coords(self, rank: int) -> Dict[str, int]:
        return self._coords[rank]

    def index(self, rank: int) -> Tuple[slice, ...]:
        """The rank's slice of the full leaf."""
        out = []
        for dim, n in enumerate(self.shape):
            axis = self._axis(dim)
            if axis is None:
                out.append(slice(None))
            else:
                blk = n // self._sizes[axis]
                c = self._coords[rank][axis]
                out.append(slice(c * blk, (c + 1) * blk))
        return tuple(out)

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(
            n if self._axis(dim) is None else n // self._sizes[self._axis(dim)] for dim, n in enumerate(self.shape)
        )

    def key(self, rank: int) -> Tuple[int, ...]:
        """Which slice the rank holds: its coordinates on the spec's axes."""
        return tuple(self._coords[rank][a] for a in self.spec if a is not None)

    def holders(self) -> Dict[Tuple[int, ...], List[int]]:
        """slice key -> the ranks holding a copy of it, in rank order."""
        out: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(len(self.devices)):
            out.setdefault(self.key(r), []).append(r)
        return out

    def shard(self, full: Any, dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        """A full tensor or numpy array cut into per-rank slices, each a copy
        of its own on its rank's device."""
        if not isinstance(full, torch.Tensor):
            full = torch.from_numpy(np.ascontiguousarray(np.asarray(full)))
        if tuple(full.shape) != self.shape:
            raise ValueError(f"leaf of shape {tuple(full.shape)} for a placement of {self.shape}")
        dtype = dtype or full.dtype
        out = []
        for r, dev in enumerate(self.devices):
            part = full[self.index(r)]
            out.append(torch.empty(part.shape, dtype=dtype, device=dev).copy_(part))
        return out

    def assemble(self, shards: Sequence[Optional[torch.Tensor]], device: Any = "cpu") -> Optional[torch.Tensor]:
        """The full leaf from per-rank slices, bit for bit (each slice read
        from the first rank that holds it); None if every slice is None."""
        first = next((s for s in shards if s is not None), None)
        if first is None:
            return None
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        for ranks in self.holders().values():
            src = shards[ranks[0]]
            out[self.index(ranks[0])] = 0 if src is None else src.detach().to(device)
        return out


class ShardedTensor:
    """A live leaf on the mesh: its placement (``sharding``) and one tensor
    per rank (``shards``, ``mesh.flat()`` order).

    It is not a tensor: torch and numpy refuse it, so code that forgets the
    placement fails instead of assembling the whole leaf on one rank. The
    whole value is ``full()``; the train step, the trainer and the
    checkpoint use the slices."""

    def __init__(self, sharding: Sharded, shards: List[torch.Tensor]):
        if len(shards) != len(sharding.devices):
            raise ValueError(f"{len(shards)} slices for a mesh of {len(sharding.devices)} ranks")
        self.sharding = sharding
        self.shards = shards

    @classmethod
    def place(cls, sharding: Sharded, full: Any, dtype: Optional[torch.dtype] = None) -> "ShardedTensor":
        return cls(sharding, sharding.shard(full, dtype))

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.sharding.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def ndim(self) -> int:
        return len(self.sharding.shape)

    def nbytes_per_rank(self) -> List[int]:
        return [s.numel() * s.element_size() for s in self.shards]

    @torch.no_grad()
    def full(self, device: Any = None) -> torch.Tensor:
        return self.sharding.assemble(self.shards, self.shards[0].device if device is None else device)

    @torch.no_grad()
    def write(self, full: Any) -> None:
        """Copy each rank's slice of a full host or device value into its
        tensor, in place."""
        if not isinstance(full, torch.Tensor):
            full = torch.from_numpy(np.ascontiguousarray(np.asarray(full)))
        if tuple(full.shape) != self.sharding.shape:
            raise ValueError(f"value of shape {tuple(full.shape)} for a leaf of {self.sharding.shape}")
        for r, s in enumerate(self.shards):
            s.copy_(full[self.sharding.index(r)])

    def __repr__(self) -> str:
        return f"ShardedTensor({self.sharding.spec!r}, shape={tuple(self.sharding.shape)}, dtype={self.dtype})"


def assemble_tree(tree: Any, device: Any = "cpu") -> Any:
    """Every ``ShardedTensor`` of a tree as its full value on ``device``."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.full(device) if isinstance(x, ShardedTensor) else x for x in leaves])
