"""ResNet-18 with GroupNorm for CIFAR-10, capability config 2 (ported from
``distributedvolunteercomputing_tpu/models/resnet.py``).

The parameter tree is the reference's: conv kernels ``[kh, kw, c_in, c_out]``
(HWIO), GroupNorm ``g``/``b`` per block, a dense head, so params carry over
leaf for leaf. The public functions take NHWC images as the reference does;
inside, activations run NCHW for ``F.conv2d`` (the reference leaves its convs
to XLA's ``conv_general_dilated``, outside any Pallas kernel).

``padding="SAME"`` is XLA's: the total pad ``max((ceil(n / s) - 1) * s + k
- n, 0)`` is split with the smaller half first, so a 3x3 stride-2 conv on an
even size pads 0 before and 1 after. ``_same_pad`` pads to that split
explicitly; ``conv2d(padding=1)`` would pad both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from distributedvolunteercomputing_tpu_torch.models import common


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    n_classes: int = 10
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)  # ResNet-18
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    stem_width: int = 64
    groups: int = 8  # GroupNorm groups


def _conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int) -> torch.Tensor:
    fan_in = kh * kw * c_in
    return common._normal(gen, (kh, kw, c_in, c_out), (2.0 / fan_in) ** 0.5)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME split of the pad along one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] (NCHW) with an HWIO kernel, SAME padding as XLA pads."""
    dtype = common.compute_dtype(x.device)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    x = x.to(dtype)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(dtype).permute(3, 2, 0, 1), stride=stride)


def _groupnorm_init(c: int, device: torch.device) -> common.Params:
    return {
        "g": torch.ones((c,), dtype=torch.float32, device=device),
        "b": torch.zeros((c,), dtype=torch.float32, device=device),
    }


def _groupnorm(p: common.Params, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Population statistics in f32 over each group's channels and space;
    ``g``/``b`` applied in f32 before the cast back."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, groups, c // groups, h, w)
    mu = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return (xf * p["g"][:, None, None] + p["b"][:, None, None]).to(x.dtype)


def _block_init(gen: torch.Generator, c_in: int, c_out: int, dtype: Optional[torch.dtype]) -> common.Params:
    dev = gen.device
    p = {
        "conv1": _conv_init(gen, 3, 3, c_in, c_out),
        "gn1": _groupnorm_init(c_out, dev),
        "conv2": _conv_init(gen, 3, 3, c_out, c_out),
        "gn2": _groupnorm_init(c_out, dev),
    }
    if c_in != c_out:
        p["proj"] = _conv_init(gen, 1, 1, c_in, c_out)
        p["gn_proj"] = _groupnorm_init(c_out, dev)
    return common.cast(p, dtype)


def _block(p: common.Params, x: torch.Tensor, stride: int, groups: int) -> torch.Tensor:
    h = _conv(p["conv1"], x, stride)
    h = torch.relu(_groupnorm(p["gn1"], h, groups))
    h = _conv(p["conv2"], h)
    h = _groupnorm(p["gn2"], h, groups)
    if "proj" in p:
        x = _groupnorm(p["gn_proj"], _conv(p["proj"], x, stride), groups)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return torch.relu(h + x)


def init(gen: torch.Generator, cfg: ResNetConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    params: Dict = {
        "stem": common.cast(_conv_init(gen, 3, 3, 3, cfg.stem_width), dtype),
        "gn_stem": common.cast(_groupnorm_init(cfg.stem_width, gen.device), dtype),
        "head": common.cast(common.dense_init(gen, cfg.widths[-1], cfg.n_classes), dtype),
    }
    c_in = cfg.stem_width
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_sizes, cfg.widths)):
        for bi in range(n_blocks):
            params[f"s{si}b{bi}"] = _block_init(gen, c_in, width, dtype)
            c_in = width
    return params


def forward(params: common.Params, x: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """Class logits [B, n_classes] (f32) of NHWC images ``x``."""
    # Contiguous NCHW: the CPU's oneDNN conv backward crashes on the
    # channels-last strides of a permuted view.
    x = x.permute(0, 3, 1, 2).contiguous()
    h = torch.relu(_groupnorm(params["gn_stem"], _conv(params["stem"], x), cfg.groups))
    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = _block(params[f"s{si}b{bi}"], h, stride, cfg.groups)
    h = h.mean(dim=(2, 3))  # global average pool
    return common.dense(params["head"], h).float()


def loss_fn(
    params: common.Params, batch: Dict[str, torch.Tensor], rng: torch.Generator, cfg: ResNetConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch["x"], cfg)
    loss = common.softmax_xent(logits, batch["y"])
    return loss, {"loss": loss, "accuracy": common.accuracy(logits, batch["y"])}
