"""Graph convolution over meshes. Port of ``kaolin_tpu/ops/gcn.py``
(reference ``kaolin/ops/gcn.py:24-199``).

A sparse adjacency is a ``torch.sparse_coo_tensor`` (the JAX package's
``BCOO``); a dense one is a plain tensor. ``GraphConv`` is an
``nn.Module`` with the JAX layer's parameters (``weight``, ``bias``,
``weight_self``, ``bias_self``).
"""

import numpy as np
import torch
from torch import nn

__all__ = ['sparse_bmm', 'normalize_adj', 'GraphConv']


def sparse_bmm(sparse_matrix, dense_matrix_batch):
    """Multiplies a (sparse or dense) matrix with a batched dense matrix.

    Reference: ``kaolin/ops/gcn.py:24``.

    Args:
        sparse_matrix: (M, N) sparse COO or dense tensor.
        dense_matrix_batch: (batch_size, N, P).

    Returns:
        (batch_size, M, P).
    """
    m, n = sparse_matrix.shape
    b, _, p = dense_matrix_batch.shape
    dense = dense_matrix_batch.permute(1, 0, 2).reshape(n, b * p)
    if sparse_matrix.is_sparse:
        result = torch.sparse.mm(sparse_matrix, dense)
    else:
        result = sparse_matrix @ dense
    return result.reshape(m, b, p).permute(1, 0, 2)


def normalize_adj(adj):
    """Row-normalizes an adjacency matrix (sparse COO or dense): each entry
    divided by its row's sum.

    Reference: ``kaolin/ops/gcn.py:48``.
    """
    ones = torch.ones((adj.shape[0], 1), dtype=adj.dtype, device=adj.device)
    if adj.is_sparse:
        adj = adj.coalesce()
        norm = torch.sparse.mm(adj, ones)[:, 0]
        indices = adj.indices()
        values = adj.values() / norm[indices[0]]
        return torch.sparse_coo_tensor(indices, values, adj.shape)
    return adj / (adj @ ones)


class GraphConv(nn.Module):
    """Graph convolution: ``A (H W + b) (+ H W_self + b_self)``.

    Reference: ``kaolin/ops/gcn.py:80``. The weights are drawn uniform in
    +-1/sqrt(input_dim) from ``generator`` (PyTorch's default one when
    None), ``weight`` first; the biases start at 0, as the JAX layer's
    ``init``.
    """

    def __init__(self, input_dim, output_dim, self_layer=True, bias=True,
                 generator=None, dtype=torch.float32, device='cuda'):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.self_layer = self_layer
        self.use_bias = bias
        bound = 1. / np.sqrt(input_dim)

        def uniform():
            w = torch.rand((input_dim, output_dim), generator=generator,
                           dtype=dtype, device=generator.device
                           if generator is not None else 'cpu')
            return nn.Parameter(((2. * w - 1.) * bound).to(device))

        def zeros():
            return nn.Parameter(torch.zeros((output_dim,), dtype=dtype,
                                            device=device))

        self.weight = uniform()
        self.bias = zeros() if bias else None
        self.weight_self = uniform() if self_layer else None
        self.bias_self = zeros() if self_layer and bias else None

    def forward(self, node_feat, adj, normalize_adj=True):
        """(batch_size, num_nodes, input_dim) features and an (N, N)
        adjacency to (batch_size, num_nodes, output_dim)."""
        if normalize_adj:
            adj = globals()['normalize_adj'](adj)
        h = node_feat @ self.weight
        if self.bias is not None:
            h = h + self.bias
        out = sparse_bmm(adj, h) if adj.is_sparse \
            else torch.einsum('mn,bnp->bmp', adj, h)
        if self.self_layer:
            hs = node_feat @ self.weight_self
            if self.bias_self is not None:
                hs = hs + self.bias_self
            out = out + hs
        return out
