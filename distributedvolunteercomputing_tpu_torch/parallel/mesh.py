"""Device mesh of one volunteer (ported from
``distributedvolunteercomputing_tpu/parallel/mesh.py``).

Axis convention (outer → inner): ``("dp", "sp", "pp", "ep", "tp")``, as in
the reference; every mesh carries all five names, and axes of size 1 cost
nothing.

The port's ``Mesh`` is an array of ``torch.device``s with those axis names.
One entry is one logical rank. An explicit ``devices`` list may name a card
more than once: the ranks then share it, each with its own buffers (and, in
the codec, its own CUDA stream). That is the port's counterpart of the
reference's virtual CPU devices, and how a one-card machine runs a two-rank
mesh. ``shard_map_manual`` is not ported: the port's sharded step places
and moves slices itself (``parallel/train_step.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

AXES = ("dp", "sp", "pp", "ep", "tp")

DeviceSpec = Union[str, torch.device]


class Mesh:
    """``devices``: an object array of ``torch.device`` shaped like the axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> List[torch.device]:
        """The ranks in row-major order (the codec's 1-D view)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({mesh_shape(self)}, {[str(d) for d in self.flat()]})"

    # ``with mesh:`` as the reference's Mesh allows; the port places
    # explicitly, so the block sets nothing.
    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        return None


def make_mesh(
    dp: int = 1,
    sp: int = 1,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    devices: Optional[Sequence[DeviceSpec]] = None,
) -> Mesh:
    """Build a ``(dp, sp, pp, ep, tp)`` mesh from the first
    dp*sp*pp*ep*tp devices: the visible cards when ``devices`` is None."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    need = dp * sp * pp * ep * tp
    if len(devices) < need:
        raise ValueError(
            f"mesh dp={dp} sp={sp} pp={pp} ep={ep} tp={tp} needs {need} "
            f"devices, have {len(devices)}"
        )
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(dp, sp, pp, ep, tp), AXES)


def mesh_shape(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def parse_mesh_spec(spec: str) -> dict:
    """Parse a ``"dp=2,tp=2"``-style CLI mesh spec into make_mesh kwargs,
    with errors that name the expected format (a bare int() traceback from
    deep inside volunteer startup helps nobody)."""
    axes: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue  # tolerate a trailing comma
        k, eq, v = part.partition("=")
        k = k.strip()
        if not eq or k not in AXES or not v.strip().isdigit() or int(v) < 1:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected comma-separated axis=N "
                f"with axes from {AXES} and N >= 1 (e.g. 'dp=2,tp=2'); "
                f"offending part: {part!r}"
            )
        axes[k] = int(v)
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}: expected e.g. 'dp=2,tp=2'")
    return axes
