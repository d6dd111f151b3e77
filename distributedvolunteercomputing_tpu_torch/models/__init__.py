from distributedvolunteercomputing_tpu_torch.models.registry import ModelBundle, get_model

__all__ = ["ModelBundle", "get_model"]
