"""The plain reference of the MC-CNN-fast matching cost (Zbontar and LeCun,
JMLR 2016, the "fast" architecture) that the ``video_h`` configuration
computes every frame: 3 x 3 convolutions with zero "SAME" padding and ReLU
between them on the grayscale image scaled as ``(I - 128) / 64``,
L2-normalised features, and the cost ``1 - <f0(x), f1(x - d)>`` with the
right features edge-padded on the left and the out-of-view columns ``x <
d`` filled from column ``min(d, W - 1)`` (the reference C++'s
``fillOutOfView``).

Plain torch in float32, TF32 off as the configuration states; the weights
[(weight OIHW, bias), ...] are the ones the benchmark drew from the seed
and handed to the program too. It imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(allow: bool):
    """cuDNN's and cuBLAS's TF32 switches set to ``allow`` for the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = allow
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


@torch.no_grad()
def features(layers, image: torch.Tensor, allow_tf32: bool = False):
    """[H, W, C] normalised features of an [H, W, c_in] 0..255 image."""
    x = ((image.to(torch.float32) - 128.0) / 64.0).permute(2, 0, 1)[None]
    with tf32(allow_tf32):
        for i, (wt, b) in enumerate(layers):
            x = F.conv2d(x, wt, b, padding=1)
            if i < len(layers) - 1:
                x = torch.relu(x)
    x = x[0].permute(1, 2, 0)
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / norm.clamp(min=1e-6)


@torch.no_grad()
def cost_at(f0: torch.Tensor, f1: torch.Tensor, d: torch.Tensor,
            y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The volume's values at positions (d, y, x) [K]."""
    w = f0.shape[1]
    xc = torch.where(x >= d, x, d.clamp(max=w - 1))
    xs = (xc - d).clamp(min=0)
    return 1.0 - (f0[y, xc] * f1[y, xs]).sum(-1)


@torch.no_grad()
def volume(f0: torch.Tensor, f1: torch.Tensor, ndisp: int) -> torch.Tensor:
    """The whole [ndisp, H, W] volume, a plane at a time."""
    h, w = f0.shape[:2]
    x = torch.arange(w, device=f0.device)
    out = torch.empty((ndisp, h, w), dtype=torch.float32, device=f0.device)
    for d in range(ndisp):
        dd = torch.full_like(x, d)
        xc = torch.where(x >= dd, x, dd.clamp(max=w - 1))
        xs = (xc - dd).clamp(min=0)
        out[d] = 1.0 - (f0[:, xc] * f1[:, xs]).sum(-1)
    return out
