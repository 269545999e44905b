"""SPC octree scan, points, query and dual ops. Port of
``kaolin_tpu/ops/spc/spc.py`` (reference ``kaolin/ops/spc/spc.py:38-467``).

Layout (as ``spc_math.h`` / ``spc_utils.cuh``):

- ``octrees``: packed uint8 byte stream, breadth-first levels 0..L-1; bit i
  of a byte = occupancy of child octant ``i = x<<2 | y<<1 | z``.
- ``exsum``: per-octree exclusive prefix sum of byte popcounts, size
  ``osize + 1``; the children of node ``i`` are ``exsum[i] + 1 ..
  exsum[i + 1]``.
- ``pyramids``: (batch, 2, max_level + 2) int32 numpy; ``[:, 0, l]`` =
  number of nodes at level l, ``[:, 1, l]`` = offset of level l in the
  point hierarchy, ``[:, 1, max_level + 1]`` = total points.
- ``point_hierarchies``: packed (num_points_total, 3) int16, all levels
  concatenated per octree, Morton-sorted within each level.

The structure (scan, points, dual, trinkets) is built on the host with
numpy (octree bytes with the native library) and lands on the input's
device; :func:`unbatched_query` and
:func:`to_dense` are tensor operations on the inputs' device.
"""

import math

import numpy as np
import torch

from ...native import points_to_octree_fast
from ...casts import to_int
from .points import _compact3_np, _morton_np
from .uint8 import POPCOUNT8, popcount8

__all__ = [
    'scan_octrees',
    'generate_points',
    'to_dense',
    'feature_grids_to_spc',
    'unbatched_query',
    'unbatched_get_level_points',
    'unbatched_make_dual',
    'unbatched_make_trinkets',
]

_CORNERS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing='ij'),
                    axis=-1).reshape(8, 3)


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _device(a):
    return a.device if torch.is_tensor(a) else 'cpu'


def _points_np(m):
    return np.stack([_compact3_np(m >> 2), _compact3_np(m >> 1),
                     _compact3_np(m)], axis=-1).astype(np.int16)


def scan_octrees(octrees, lengths):
    """Scans batched octree byte streams.

    Args:
        octrees: packed uint8 byte stream.
        lengths: (batch_size,) int byte counts.

    Returns:
        (max_level (int), pyramids (numpy int32 (B, 2, L+2)), exsum (int32
        tensor of size total_bytes + batch_size, on the octrees' device)).
    """
    octrees_np = _host(octrees)
    lengths_np = _host(lengths)
    pyramids = []
    exsums = []
    max_level = 0
    start = 0
    level_counts_all = []
    for b in range(lengths_np.shape[0]):
        osize = int(lengths_np[b])
        octree = octrees_np[start:start + osize]
        start += osize
        exsum = np.zeros(osize + 1, dtype=np.int32)
        np.cumsum(POPCOUNT8[octree], out=exsum[1:])
        exsums.append(exsum)
        # walk level sizes (scan_octrees.cu:91-105)
        level_counts = [1]
        total = 1
        while total <= osize:
            lsize = int(exsum[total] - exsum[total - level_counts[-1]])
            level_counts.append(lsize)
            total += lsize
        level_counts_all.append(level_counts)
        max_level = max(max_level, len(level_counts) - 1)
    for level_counts in level_counts_all:
        pyr = np.zeros((2, max_level + 2), dtype=np.int32)
        pyr[0, :len(level_counts)] = level_counts
        pyr[1, 1:] = np.cumsum(pyr[0, :-1])
        pyramids.append(pyr)
    return (max_level, np.stack(pyramids),
            torch.as_tensor(np.concatenate(exsums), device=_device(octrees)))


def generate_points(octrees, pyramids, exsum):
    """Expands octree bytes into explicit point hierarchies (host numpy).

    Returns:
        int16 (total_points, 3) packed point hierarchies, on the octrees'
        device.
    """
    octrees_np = _host(octrees)
    pyramids_np = _host(pyramids)
    out = []
    start = 0
    for b in range(pyramids_np.shape[0]):
        # octree b's own depth: scan_octrees leaves the counts of the
        # levels below a shallower octree at 0, and every level of an
        # octree holds a node
        level = int(np.count_nonzero(pyramids_np[b, 0])) - 1
        osize = int(pyramids_np[b, 1, level])  # bytes = nodes thru level-1
        octree = octrees_np[start:start + osize]
        start += osize
        mortons = [np.zeros(1, dtype=np.int64)]
        byte_off = 0
        for l in range(level):
            n_l = int(pyramids_np[b, 0, l])
            bytes_l = octree[byte_off:byte_off + n_l]
            byte_off += n_l
            bits = np.unpackbits(bytes_l[:, None], axis=1, bitorder='little')
            par_idx, child = np.nonzero(bits)
            mortons.append((mortons[l][par_idx] << 3)
                           | child.astype(np.int64))
        out.append(np.concatenate([_points_np(m) for m in mortons], axis=0))
    return torch.as_tensor(np.concatenate(out, axis=0),
                           device=_device(octrees))


def unbatched_get_level_points(point_hierarchy, pyramid, level):
    """Point set of one level from the hierarchy."""
    pyramid = _host(pyramid)
    return point_hierarchy[int(pyramid[1, level]):int(pyramid[1, level + 1])]


def unbatched_query(octree, exsum, query_coords, level, with_parents=False):
    """Point-hierarchy indices of coordinates, by walking the octree from
    the root (``query_cuda.cu`` / ``spc_utils.cuh identify``).

    Args:
        octree: (num_bytes,) uint8.
        exsum: (num_bytes + 1,) int32 exclusive popcount prefix sum.
        query_coords: (num_query, 3); float in [-1, 1] or int in
            [0, 2^level].
        level (int): query level.
        with_parents: also return indices at every ancestor level.

    Returns:
        (num_query,) int32, or (num_query, level + 1) if ``with_parents``;
        -1 where empty.
    """
    if query_coords.is_floating_point():
        coords = to_int(torch.floor((query_coords * 0.5 + 0.5)
                                    * (2 ** level)), torch.int32)
    else:
        coords = query_coords.to(torch.int32)
    maxval = (1 << level) - 1
    in_bounds = torch.all((coords >= 0) & (coords <= maxval), dim=-1)

    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    ord_ = torch.zeros(coords.shape[0], dtype=torch.int64,
                       device=coords.device)
    alive = in_bounds
    minus1 = torch.full_like(ord_, -1)
    results = [torch.where(in_bounds, 0, -1).to(torch.int32)]
    for l in range(level):
        depth = level - l - 1
        child = (((x >> depth) & 1) << 2) | (((y >> depth) & 1) << 1) \
            | ((z >> depth) & 1)
        bits = octree[ord_].to(torch.int32)
        has = ((bits >> child) & 1) > 0
        cnt = popcount8(bits & ((2 << child) - 1))
        nxt = exsum[ord_].to(torch.int64) + cnt
        alive = alive & has
        ord_ = torch.where(alive, nxt, ord_)
        results.append(torch.where(alive, ord_, minus1).to(torch.int32))
    if with_parents:
        return torch.stack(results, dim=-1)
    return results[-1]


def unbatched_make_dual(point_hierarchy, pyramid):
    """Dual octree (voxel corners) point hierarchy and pyramid (host
    numpy); the hierarchy lands on ``point_hierarchy``'s device."""
    pyramid = _host(pyramid)
    ph = _host(point_hierarchy).astype(np.int64)
    levels = pyramid.shape[1] - 1
    pyramid_dual = np.zeros_like(pyramid)
    duals = []
    for i in range(levels):
        pts = ph[int(pyramid[1, i]):int(pyramid[1, i + 1])]
        corners = (pts[:, None, :] + _CORNERS[None]).reshape(-1, 3)
        pts_dual = _points_np(np.unique(_morton_np(corners)))
        duals.append(pts_dual)
        pyramid_dual[0, i] = pts_dual.shape[0]
        if i > 0:
            pyramid_dual[1, i] = (pyramid_dual[0, i - 1]
                                  + pyramid_dual[1, i - 1])
    pyramid_dual[1, levels] = (pyramid_dual[0, levels - 1]
                               + pyramid_dual[1, levels - 1])
    return (torch.as_tensor(np.concatenate(duals, axis=0),
                            device=_device(point_hierarchy)), pyramid_dual)


def unbatched_make_trinkets(point_hierarchy, pyramid, point_hierarchy_dual,
                            pyramid_dual):
    """Indices of each primary node's 8 corners in the dual hierarchy, and
    each point's parent (host numpy).

    Returns:
        (trinkets (num_points, 8) int32, parents (num_points,) int32 --
        index of each point's parent in the point hierarchy, -1 for the
        root), on ``point_hierarchy``'s device.
    """
    pyramid = _host(pyramid)
    pyramid_dual = _host(pyramid_dual)
    ph = _host(point_hierarchy).astype(np.int64)
    phd = _host(point_hierarchy_dual).astype(np.int64)
    levels = pyramid.shape[1] - 1
    trinkets = []
    parents = []
    for i in range(levels):
        pts = ph[int(pyramid[1, i]):int(pyramid[1, i + 1])]
        dual_lvl = phd[int(pyramid_dual[1, i]):
                       int(pyramid_dual[1, i]) + int(pyramid_dual[0, i])]
        corners = (pts[:, None, :] + _CORNERS[None]).reshape(-1, 3)
        loc = np.searchsorted(_morton_np(dual_lvl), _morton_np(corners))
        trinkets.append((loc + int(pyramid_dual[1, i])
                         ).reshape(-1, 8).astype(np.int32))
        if i == 0:
            parents.append(np.full(pts.shape[0], -1, dtype=np.int32))
        else:
            parent_pts = ph[int(pyramid[1, i - 1]):int(pyramid[1, i])]
            loc = np.searchsorted(_morton_np(parent_pts), _morton_np(pts >> 1))
            parents.append((loc + int(pyramid[1, i - 1])).astype(np.int32))
    device = _device(point_hierarchy)
    return (torch.as_tensor(np.concatenate(trinkets, axis=0), device=device),
            torch.as_tensor(np.concatenate(parents, axis=0), device=device))


def to_dense(point_hierarchies, pyramids, input, level=-1):
    """Scatters SPC features at ``level`` into dense (B, C, D, D, D) grids.

    Differentiable with respect to ``input`` (autograd of the index
    write).
    """
    pyramids_np = _host(pyramids)
    max_level = pyramids_np.shape[2] - 2
    if level < 0:
        level = max_level + 1 + level
    dim = 2 ** level
    feat_dim = input.shape[-1]
    outs = []
    in_off = 0
    ph_off = 0
    for b in range(pyramids_np.shape[0]):
        n = int(pyramids_np[b, 0, level])
        off = int(pyramids_np[b, 1, level])
        total = int(pyramids_np[b, 1, max_level + 1])
        pts = point_hierarchies[ph_off + off:ph_off + off + n].to(torch.int64)
        flat_idx = (pts[:, 0] * dim + pts[:, 1]) * dim + pts[:, 2]
        grid = torch.zeros((dim * dim * dim, feat_dim), dtype=input.dtype,
                           device=input.device)
        grid = grid.index_put((flat_idx.to(input.device),),
                              input[in_off:in_off + n])
        outs.append(grid.reshape(dim, dim, dim, feat_dim).permute(3, 0, 1, 2))
        in_off += n
        ph_off += total
    return torch.stack(outs)


def feature_grids_to_spc(feature_grids, masks=None):
    """Converts dense feature grids (B, C, X, Y, Z) to an SPC (octrees,
    lengths, features), features coalesced in Morton order. The structure
    is built on the host; octrees and features land on the grids'
    device."""
    fg = _host(feature_grids)
    batch_size, feat_dim = fg.shape[0], fg.shape[1]
    x_dim, y_dim, z_dim = fg.shape[2:5]
    fg = np.transpose(fg, (0, 2, 3, 4, 1))
    level = int(math.ceil(math.log2(max(x_dim, y_dim, z_dim))))
    max_dim = 2 ** level
    padded = np.zeros((batch_size, max_dim, max_dim, max_dim, feat_dim),
                      dtype=fg.dtype)
    padded[:, :x_dim, :y_dim, :z_dim] = fg
    if masks is None:
        masks_np = np.any(padded != 0, axis=-1)
    else:
        masks_np = np.zeros((batch_size, max_dim, max_dim, max_dim),
                            dtype=bool)
        masks_np[:, :x_dim, :y_dim, :z_dim] = _host(masks)
    octrees = []
    lengths = []
    features = []
    for b in range(batch_size):
        idx = np.argwhere(masks_np[b])
        if idx.shape[0] == 0:
            octrees.append(np.zeros(1, dtype=np.uint8))
            lengths.append(1)
            features.append(np.zeros((0, feat_dim), dtype=fg.dtype))
            continue
        morton = np.sort(_morton_np(idx))
        pts = _points_np(morton)
        features.append(padded[b][pts[:, 0], pts[:, 1], pts[:, 2]])
        octree = points_to_octree_fast(pts, level)
        octrees.append(octree)
        lengths.append(octree.shape[0])
    device = _device(feature_grids)
    return (torch.as_tensor(np.concatenate(octrees), device=device),
            np.asarray(lengths, dtype=np.int32),
            torch.as_tensor(np.concatenate(features, axis=0), device=device))
