"""Sparse octree convolutions (gather-GEMM formulation). Port of
``kaolin_tpu/ops/spc/convolution.py`` (reference
``kaolin/ops/spc/convolution.py:31-465``).

The neighbourhood map comes from the octree query walk
(:func:`kaolin_tpu_torch.ops.spc.unbatched_query`, one walk for all the
kernel offsets); the convolution is, for each kernel offset in order, a
gather of the neighbours that exist, a matrix product and an add into
their rows:

``Y_i = sum_k W_k . X_{n(i,k)} + b``, with
``n(i, k) = query(2^jump * P_i + kernel_vectors[k])`` at the input level;
missing neighbours add zero. ``conv_transpose3d`` gathers through the
transposed map (the shifts that 2^jump divides). The pyramid is read on
the host. ``Conv3d`` and ``ConvTranspose3d`` are ``nn.Module``s holding
the JAX layers' parameters.
"""

import numpy as np
import torch
from torch import nn

from .spc import unbatched_get_level_points, unbatched_query

__all__ = ['conv3d', 'Conv3d', 'conv_transpose3d', 'ConvTranspose3d']


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _single(pyramids, fn):
    pyramids = _host(pyramids)
    if pyramids.shape[0] != 1:
        raise ValueError(f'{fn} expects a single octree (pyramids of batch '
                         f'size 1), got {pyramids.shape[0]}; loop over the '
                         'batch outside')
    return pyramids[0]


def _pointwise(input, weight, bias, level):
    out = input @ weight[0]
    if bias is not None:
        out = out + bias[None]
    return out, int(level)


def _gather_sum(octrees, exsum, coords, valid, level, in_off, input, weight,
                out_rows):
    """``sum_k where(found, input[n(i, k)], 0) @ weight[k]`` with ``coords``
    (K, N, 3) the query points at ``level``, ``valid`` (K, N) the rows
    that may look (None: all) and ``in_off`` the offset of ``level``'s
    points in the hierarchy.

    Only the (k, i) pairs whose neighbour exists are gathered and
    multiplied, and each offset's products are added into their rows in
    the offsets' order: a missing neighbour adds nothing where the JAX
    package adds an exact zero, so every row sums the same terms in the
    same order. (A gather of all K x N rows, the missing ones clamped to
    one row, makes that row's gradient a sum of millions of terms, which
    PyTorch's CUDA index backward adds one by one.) One host read sizes
    the offsets' lists.
    """
    K, N = coords.shape[:2]
    pidx = unbatched_query(octrees, exsum, coords.reshape(-1, 3),
                           level).reshape(K, N)
    found = pidx >= 0
    if valid is not None:
        found = found & valid
    k_idx, rows = torch.nonzero(found, as_tuple=True)
    src = pidx[k_idx, rows].long() - in_off
    counts = torch.bincount(k_idx, minlength=K).tolist()
    out = torch.zeros((out_rows, weight.shape[-1]), dtype=input.dtype,
                      device=input.device)
    for k, (r, s) in enumerate(zip(rows.split(counts), src.split(counts))):
        if r.shape[0]:
            out = out.index_add(0, r, input.index_select(0, s) @ weight[k])
    return out


def conv3d(octrees, point_hierarchies, level, pyramids, exsum, input,
           weight, kernel_vectors, jump=0, bias=None):
    """Convolution over an unbatched-structure SPC (pyramids of batch size
    1; loop batches outside).

    Reference: ``kaolin/ops/spc/convolution.py:68``.

    Args:
        octrees: (num_bytes,) uint8.
        point_hierarchies: (num_points, 3) int16.
        level (int): level of the input features.
        pyramids: (1, 2, max_level+2).
        exsum: (num_bytes + 1,) int32.
        input: (num_inputs, in_channels) features at ``level``.
        weight: (num_kernel_vectors, in_channels, out_channels).
        kernel_vectors: (num_kernel_vectors, 3) int offsets.
        jump (int): level downsampling (output level = level - jump).
        bias: optional (out_channels,).

    Returns:
        (output (num_outputs, out_channels), out_level (int)).
    """
    pyramid = _single(pyramids, 'conv3d')
    out_level = level - jump
    if out_level < 0:
        raise ValueError(f'conv3d: jump {jump} above level {level}')
    if weight.shape[0] == 1 and jump == 0:
        return _pointwise(input, weight, bias, level)

    out_pts = unbatched_get_level_points(point_hierarchies, pyramid,
                                         out_level).to(torch.int32)
    kv = torch.as_tensor(_host(kernel_vectors).astype(np.int32),
                         device=out_pts.device)
    coords = out_pts[None] * (2 ** jump) + kv[:, None]
    out = _gather_sum(octrees, exsum, coords, None, level,
                      int(pyramid[1, level]), input, weight,
                      out_pts.shape[0])
    if bias is not None:
        out = out + bias[None]
    return out, int(out_level)


def conv_transpose3d(octrees, point_hierarchies, level, pyramids, exsum,
                     input, weight, kernel_vectors, jump=0, bias=None):
    """Transposed convolution (upsampling) over an SPC.

    Reference: ``kaolin/ops/spc/convolution.py:285``. Output level =
    ``level + jump``; the neighbourhood map is the transpose of
    :func:`conv3d`'s: output point ``p`` takes ``(p - kernel_vectors[k]) /
    2^jump`` where that shift is nonnegative and divisible (floor
    remainder and division, as the JAX package's ``%`` and ``//``).

    Returns:
        (output (num_outputs, out_channels), out_level (int)).
    """
    pyramid = _single(pyramids, 'conv_transpose3d')
    out_level = level + jump
    if weight.shape[0] == 1 and jump == 0:
        return _pointwise(input, weight, bias, level)

    out_pts = unbatched_get_level_points(point_hierarchies, pyramid,
                                         out_level).to(torch.int32)
    kv = torch.as_tensor(_host(kernel_vectors).astype(np.int32),
                         device=out_pts.device)
    step = 2 ** jump
    shifted = out_pts[None] - kv[:, None]                       # (K, N, 3)
    divisible = torch.all(torch.remainder(shifted, step) == 0, dim=-1) \
        & torch.all(shifted >= 0, dim=-1)
    coarse = torch.div(shifted, step, rounding_mode='floor')
    out = _gather_sum(octrees, exsum, coarse, divisible, level,
                      int(pyramid[1, level]), input, weight,
                      out_pts.shape[0])
    if bias is not None:
        out = out + bias[None]
    return out, int(out_level)


class _ConvBase(nn.Module):
    """The layers' parameters: ``weight`` (K, in, out), drawn uniform in
    +-1/sqrt(in * K) from ``generator`` (PyTorch's default one when None),
    and ``bias`` (out,) at 0, as the JAX layers' ``init``."""

    def __init__(self, in_channels, out_channels, kernel_vectors, jump=0,
                 bias=True, generator=None, dtype=torch.float32,
                 device='cuda'):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_vectors = _host(kernel_vectors)
        self.jump = jump
        self.use_bias = bias
        K = self.kernel_vectors.shape[0]
        std = 1. / np.sqrt(in_channels * K)
        w = torch.rand((K, in_channels, out_channels), generator=generator,
                       dtype=dtype, device=generator.device
                       if generator is not None else 'cpu')
        self.weight = nn.Parameter(((2. * w - 1.) * std).to(device))
        self.bias = nn.Parameter(torch.zeros(
            (out_channels,), dtype=dtype, device=device)) if bias else None


class Conv3d(_ConvBase):
    """SPC convolution layer (reference
    ``kaolin/ops/spc/convolution.py:140``)."""

    def forward(self, octrees, point_hierarchies, level, pyramids, exsum,
                input):
        return conv3d(octrees, point_hierarchies, level, pyramids, exsum,
                      input, self.weight, self.kernel_vectors, self.jump,
                      self.bias)


class ConvTranspose3d(_ConvBase):
    """SPC transposed-convolution layer (reference
    ``kaolin/ops/spc/convolution.py:358``)."""

    def forward(self, octrees, point_hierarchies, level, pyramids, exsum,
                input):
        return conv_transpose3d(octrees, point_hierarchies, level, pyramids,
                                exsum, input, self.weight,
                                self.kernel_vectors, self.jump, self.bias)
