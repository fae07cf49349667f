"""Small convolutional classifier (MNIST-class vision) in PyTorch —
counterpart of dlrover_tpu/models/cnn.py.

The API keeps JAX's layouts: NHWC images and HWIO kernels; `apply`
permutes to torch's NCHW / OIHW inside. Stage 0 convolves at stride 1,
later stages at stride 2 (no pooling layers), each with XLA's
padding="SAME": a total padding of max((ceil(n / s) - 1) * s + k - n,
0) per spatial axis, the smaller half before and the extra row or
column AFTER (bottom, right). `F.conv2d(padding="same")` refuses
stride 2, so the padding is explicit (`F.pad`). A global average pool
(f32) feeds a dense layer and the class head; bf16 compute over f32
params, f32 logits. The convolution is XLA's in JAX, not a Pallas
kernel, so `F.conv2d` (cuDNN on the card) is its counterpart.
"""

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device

Params = Dict


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    image_size: int = 28
    in_channels: int = 1
    channels: Tuple[int, ...] = (16, 32, 64)  # stride-2 after stage 0
    kernel: int = 3
    dense_dim: int = 128
    n_classes: int = 10
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def mnist(cls, **kw) -> "CnnConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "CnnConfig":
        d = dict(image_size=8, channels=(8, 16), dense_dim=32)
        d.update(kw)
        return cls(**d)


def init_params(cfg: CnnConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random params in JAX's layout (HWIO kernels) and scales (normal /
    sqrt(fan_in), zero biases), in `cfg.param_dtype` on `device`."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=pd)
        return w.mul_(1.0 / math.sqrt(fan_in))

    params: Params = {}
    cin = cfg.in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}_w"] = dense((cfg.kernel, cfg.kernel, cin, cout),
                                     cfg.kernel * cfg.kernel * cin)
        params[f"conv{i}_b"] = torch.zeros((cout,), device=dev, dtype=pd)
        cin = cout
    params["dense_w"] = dense((cin, cfg.dense_dim), cin)
    params["dense_b"] = torch.zeros((cfg.dense_dim,), device=dev, dtype=pd)
    params["head_w"] = dense((cfg.dense_dim, cfg.n_classes), cfg.dense_dim)
    params["head_b"] = torch.zeros((cfg.n_classes,), device=dev, dtype=pd)
    return params


def params_from_numpy(cfg: CnnConfig, tree: Dict,
                      device: DeviceLike = None) -> Params:
    """The JAX param dict of numpy arrays -> the port's params, in
    `cfg.param_dtype` on `device`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(
        device=dev, dtype=cfg.param_dtype) for k, v in tree.items()}


def partition_rules(cfg: CnnConfig):
    """JAX's `partition_rules` (cnn.py:79): the convolutions replicated,
    the head products on the tensor axis (column then row parallel); no
    rule names fsdp."""
    from dlrover_tpu_torch.parallel.mesh import PartitionSpec as P

    return [
        (r"conv\d+_w$", P(None, None, None, None)),
        (r"conv\d+_b$", P(None)),
        (r"dense_w$", P(None, "tensor")),
        (r"dense_b$", P("tensor")),
        (r"head_w$", P("tensor", None)),
        (r"head_b$", P(None)),
    ]


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (before, after), the odd unit
    after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def apply(cfg: CnnConfig, params: Params, images: torch.Tensor):
    """images [B, H, W, Cin] (NHWC) -> logits [B, n_classes] f32."""
    cd = cfg.dtype
    x = images.to(cd).permute(0, 3, 1, 2)            # NCHW
    for i in range(len(cfg.channels)):
        stride = 1 if i == 0 else 2
        w = params[f"conv{i}_w"].to(cd).permute(3, 2, 0, 1)   # OIHW
        top, bottom = _same_pad(x.shape[2], cfg.kernel, stride)
        left, right = _same_pad(x.shape[3], cfg.kernel, stride)
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
        x = F.relu(x + params[f"conv{i}_b"].to(cd)[None, :, None, None])
    x = x.float().mean(dim=(2, 3)).to(cd)             # global average pool
    h = F.relu(x @ params["dense_w"].to(cd) + params["dense_b"].to(cd))
    logits = h @ params["head_w"].to(cd) + params["head_b"].to(cd)
    return logits.float()


def loss_fn(cfg: CnnConfig, params: Params, batch: Dict):
    """batch = {"images": [B, H, W, C], "labels": [B] int} -> (loss,
    {"loss", "accuracy"})."""
    logits = apply(cfg, params, batch["images"])
    labels = batch["labels"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def num_params(cfg: CnnConfig) -> int:
    total, cin = 0, cfg.in_channels
    for cout in cfg.channels:
        total += cfg.kernel * cfg.kernel * cin * cout + cout
        cin = cout
    return (total + cin * cfg.dense_dim + cfg.dense_dim
            + cfg.dense_dim * cfg.n_classes + cfg.n_classes)
