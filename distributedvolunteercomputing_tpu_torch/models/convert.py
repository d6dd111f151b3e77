"""Carry the JAX package's params into the port.

``params_from_jax`` takes the JAX params as a nested dict of numpy arrays
(``jax.tree_util.tree_map(np.asarray, bundle.init(key))``; the caller does
the conversion, so this module needs no jax) and returns the port's tree with
the same keys, shapes and dtypes. The two trees share a layout, so the copy is
leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_map


def _to_tensor(a: Any, device: Union[str, torch.device]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: numpy-to-torch has no bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Any, device: Union[str, torch.device]) -> Any:
    return tree_map(lambda a: _to_tensor(a, device), tree)
