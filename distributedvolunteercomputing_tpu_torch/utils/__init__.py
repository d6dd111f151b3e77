from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import (
    TensorSpec,
    flatten_to_buffer,
    unflatten_from_buffer,
)
from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype, resolve_device

__all__ = [
    "TensorSpec",
    "compute_dtype",
    "flatten_to_buffer",
    "get_logger",
    "resolve_device",
    "unflatten_from_buffer",
]
