from distributedvolunteercomputing_tpu_torch.ops.attention import (
    multi_head_attention,
    set_attention_impl,
)

__all__ = ["multi_head_attention", "set_attention_impl"]
