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
card the convolutions run in full float32, forward and backward: cuDNN
would take TF32 by default, which puts the volume about 1e-3 off its CPU
twin. :class:`MCCNN` is differentiable (the trainer,
``tools/train_mccnn.py``); :func:`features` and :func:`cost_volume` run it
without autograd.

Weights travel as the JAX package's pytree of numpy arrays (``w{i}`` HWIO
``(3, 3, Cin, Cout)``, ``b{i}``) in ``.npz`` files with the same keys;
:func:`params_from_jax` turns one into the module and
:func:`params_to_jax` back. The bundled trained
weights are the port's own copy, ``models/weights/mccnn_fast_v2.npz``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import rng

#: Feature tower: out channels of each 3 x 3 convolution.
DEFAULT_CHANNELS = (32, 32, 64, 64)


class MCCNN(torch.nn.Module):
    """The feature tower: 3 x 3 convolutions, ReLU between them."""

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
        """[H, W, C] L2-normalized matching features of a [H, W, 3] image
        (0..255, numpy or tensor), on the network's device, differentiable
        in the weights. On the card every convolution, forward and
        backward, runs in full float32."""
        dev = self.convs[0].weight.device
        x = torch.as_tensor(image, dtype=torch.float32, device=dev)
        x = ((x - 128.0) / 64.0).permute(2, 0, 1)[None]
        n = len(self.convs)
        for i, conv in enumerate(self.convs):
            x = _Conv3x3.apply(x, conv.weight, conv.bias)
            if i < n - 1:
                x = F.relu(x)
        x = x[0].permute(1, 2, 0)
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return (x / torch.clamp(norm, min=1e-6)).contiguous()


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


def init_params_from_key(key: torch.Tensor,
                         channels: Sequence[int] = DEFAULT_CHANNELS,
                         in_channels: int = 3) -> Dict[str, np.ndarray]:
    """The JAX package's ``init_params(key)``: a split of the key a layer,
    ``normal(k, (3, 3, Cin, Cout)) * sqrt(2 / (9 Cin))`` and zero biases,
    in the JAX layout (HWIO), as numpy float32."""
    params = {}
    c_in = in_channels
    for i, c_out in enumerate(channels):
        key, k = rng.split(key)
        scale = torch.sqrt(torch.tensor(2.0 / (9 * c_in), dtype=torch.float32))
        params[f"w{i}"] = (rng.normal(k, (3, 3, c_in, c_out)) * scale).numpy()
        params[f"b{i}"] = np.zeros((c_out,), np.float32)
        c_in = c_out
    return params


def num_layers(params: Dict) -> int:
    return sum(1 for k in params if k.startswith("w"))


def params_from_jax(params: Dict) -> MCCNN:
    """The module (on the CPU) holding a JAX-layout pytree's weights:
    ``w{i}`` HWIO -> OIHW, ``b{i}`` as they are. Its weights are frozen
    (``requires_grad`` off) until a caller that trains them, such as the
    trainer, turns it on."""
    n = num_layers(params)
    ws = [np.asarray(params[f"w{i}"], np.float32) for i in range(n)]
    net = MCCNN([w.shape[3] for w in ws], in_channels=ws[0].shape[2])
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            conv.weight.copy_(torch.from_numpy(ws[i]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(params[f"b{i}"], np.float32)))
    return net.requires_grad_(False)


def params_to_jax(net: MCCNN) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: the JAX-layout pytree of
    numpy float32 arrays (``w{i}`` OIHW -> HWIO, ``b{i}`` as they are)."""
    params = {}
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            params[f"w{i}"] = np.ascontiguousarray(
                conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy())
            params[f"b{i}"] = conv.bias.detach().cpu().numpy().copy()
    return params


def _full_float32(device: torch.device):
    """cuDNN without TF32 for the duration of a call on the card; its
    other settings stay the caller's."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv3x3(torch.autograd.Function):
    """A 3 x 3 "SAME" convolution whose forward and backward both run
    without TF32 on the card: the backward runs when the caller calls it,
    outside any context the forward could set."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        with _full_float32(x.device):
            return F.conv2d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with _full_float32(grad.device):
            return torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [1, 1], [1, 1], [1, 1],
                False, [0, 0], 1, list(ctx.needs_input_grad))


@torch.no_grad()
def features(net: MCCNN, image) -> torch.Tensor:
    """[H, W, C] L2-normalized matching features of a [H, W, 3] image
    (0..255, numpy or tensor), on the network's device; no autograd."""
    return net(image)


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
