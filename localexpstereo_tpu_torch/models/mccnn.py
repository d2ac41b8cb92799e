"""MC-CNN-style matching-cost network (counterpart of
``localexpstereo_tpu.models.mccnn``).

The reference consumes cost volumes computed offline by the original
MC-CNN (``im0.acrt``, ``README.md:74-91``). This module computes the
``[D, H, W]`` volume from the rectified pair on the device: the "fast"
MC-CNN tower (four 3 x 3 convolutions, zero "SAME" padding, ReLU between
them), L2-normalized features, and the cosine matching cost
``1 - <f0(x), f1(x - d)>``.

The network is plain PyTorch (``F.conv2d`` through :class:`MCCNN`), as the
JAX package computes it in XLA: it holds no hand-written kernel. On the
card the convolutions run in full float32: cuDNN would take TF32 by
default, which puts the volume about 1e-3 off its CPU twin.

Weights travel as the JAX package's pytree of numpy arrays (``w{i}`` HWIO
``(3, 3, Cin, Cout)``, ``b{i}``) in ``.npz`` files with the same keys;
:func:`params_from_jax` turns one into the module. The bundled trained
weights are the port's own copy, ``models/weights/mccnn_fast_v2.npz``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

#: Feature tower: out channels of each 3 x 3 convolution.
DEFAULT_CHANNELS = (32, 32, 64, 64)


class MCCNN(torch.nn.Module):
    """The feature tower; ``forward`` is :func:`features`."""

    def __init__(self, channels: Sequence[int] = DEFAULT_CHANNELS,
                 in_channels: int = 3):
        super().__init__()
        convs = []
        c_in = in_channels
        for c_out in channels:
            convs.append(torch.nn.Conv2d(c_in, c_out, 3, padding=1))
            c_in = c_out
        self.convs = torch.nn.ModuleList(convs)

    def forward(self, image) -> torch.Tensor:
        return features(self, image)


def init_params(generator: np.random.Generator,
                channels: Sequence[int] = DEFAULT_CHANNELS,
                in_channels: int = 3) -> Dict[str, np.ndarray]:
    """Random He-normal weights in the JAX layout (HWIO), zero biases."""
    params = {}
    c_in = in_channels
    for i, c_out in enumerate(channels):
        scale = np.sqrt(2.0 / (9 * c_in))
        params[f"w{i}"] = (generator.standard_normal((3, 3, c_in, c_out))
                           * scale).astype(np.float32)
        params[f"b{i}"] = np.zeros((c_out,), np.float32)
        c_in = c_out
    return params


def num_layers(params: Dict) -> int:
    return sum(1 for k in params if k.startswith("w"))


def params_from_jax(params: Dict) -> MCCNN:
    """The module (on the CPU) holding a JAX-layout pytree's weights:
    ``w{i}`` HWIO -> OIHW, ``b{i}`` as they are."""
    n = num_layers(params)
    ws = [np.asarray(params[f"w{i}"], np.float32) for i in range(n)]
    net = MCCNN([w.shape[3] for w in ws], in_channels=ws[0].shape[2])
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            conv.weight.copy_(torch.from_numpy(ws[i]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(params[f"b{i}"], np.float32)))
    return net


def _full_float32(device: torch.device):
    """cuDNN without TF32 for the duration of a call on the card; its
    other settings stay the caller's."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@torch.no_grad()
def features(net: MCCNN, image) -> torch.Tensor:
    """[H, W, C] L2-normalized matching features of a [H, W, 3] image
    (0..255, numpy or tensor), on the network's device."""
    dev = net.convs[0].weight.device
    x = torch.as_tensor(image, dtype=torch.float32, device=dev)
    x = ((x - 128.0) / 64.0).permute(2, 0, 1)[None]
    n = len(net.convs)
    with _full_float32(dev):
        for i, conv in enumerate(net.convs):
            x = F.conv2d(x, conv.weight, conv.bias, padding=1)
            if i < n - 1:
                x = F.relu(x)
    x = x[0].permute(1, 2, 0)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=1e-6)).contiguous()


@torch.no_grad()
def cost_volume(net: MCCNN, im0, im1, ndisp: int) -> torch.Tensor:
    """[ndisp, H, W] float32 matching-cost volume ``1 - <f0(x), f1(x - d)>``
    on the network's device, f1 edge-padded on the left, and the
    out-of-view columns filled as the reference's ``fillOutOfView``
    (``main.cpp:152-163``): ``vol[d, y, x] = vol[d, y, clip(d, 0, W-1)]``
    for ``x < d``.

    One disparity at a time: a [ndisp, H, W, C] shifted-feature tensor
    would be 106 GB at 1436 x 992 x 145; this keeps one [H, W, C] product.
    """
    f0 = features(net, im0)
    f1 = features(net, im1)
    h, w = f0.shape[:2]
    f1_pad = torch.cat([f1[:, :1].expand(h, ndisp, f1.shape[2]), f1], dim=1)
    cols = torch.arange(w, device=f0.device)
    vol = torch.empty((ndisp, h, w), dtype=torch.float32, device=f0.device)
    for d in range(ndisp):
        cost = 1.0 - torch.sum(f0 * f1_pad[:, ndisp - d:ndisp - d + w],
                               dim=-1)
        c = min(d, w - 1)
        vol[d] = torch.where(cols >= d, cost, cost[:, c:c + 1])
    return vol


def default_weights_path() -> str:
    """The bundled trained weights (the port's copy)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "mccnn_fast_v2.npz")


def load_default_params() -> Dict[str, np.ndarray]:
    """The bundled MC-CNN-fast weights, trained on MiddV2 ground truth
    (cones, teddy, venus)."""
    return load_params(default_weights_path())


def save_params(path: str, params: Dict) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
