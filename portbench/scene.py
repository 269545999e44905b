"""Seeded scene pieces that the steps' generators share: the icosphere, a
ring of cameras, smooth target images and elliptic silhouettes. Every
tensor is drawn on the device from one ``torch.Generator``, in a few
large calls, so a seed gives the same scene on every run.

The targets steer the fit, and so the geometry and the work of the later
steps: every seed gets the same set of targets (drawn from a fixed
generator), in an order of its own, so that seeds differ in which object
fits which target and not in the work of a step."""

import math

import torch

_PHI = (1. + 5 ** 0.5) / 2.
_BASE_VERTS = [(-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
               (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
               (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1)]
_BASE_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
               (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
               (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
               (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


def icosphere(subdiv, device):
    """Unit icosphere: (vertices (V, 3) float32, faces (20 * 4**subdiv, 3)
    int64), each step splitting every face in four at its edges'
    midpoints (pushed to the sphere)."""
    verts = torch.tensor(_BASE_VERTS, dtype=torch.float64, device=device)
    verts = verts / verts.norm(dim=1, keepdim=True)
    faces = torch.tensor(_BASE_FACES, dtype=torch.int64, device=device)
    for _ in range(subdiv):
        V = verts.shape[0]
        a, b, c = faces.unbind(1)
        edges = torch.stack([torch.stack([a, b], 1), torch.stack([b, c], 1),
                             torch.stack([c, a], 1)], 0)       # (3, F, 2)
        lo, hi = edges.amin(-1), edges.amax(-1)
        keys, inv = torch.unique(lo * V + hi, return_inverse=True)
        mid = verts[keys // V] + verts[keys % V]
        verts = torch.cat([verts, mid / mid.norm(dim=1, keepdim=True)])
        ab, bc, ca = (V + inv).unbind(0)
        faces = torch.cat([torch.stack([a, ab, ca], 1),
                           torch.stack([b, bc, ab], 1),
                           torch.stack([c, ca, bc], 1),
                           torch.stack([ab, bc, ca], 1)])
    return verts.float(), faces


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def uniform(gen, shape, lo, hi, device, dtype=torch.float32):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=dtype)


def bumpy_copies(base, batch, amplitude, gen):
    """``batch`` copies of the unit-sphere vertices ``base``, each vertex
    moved radially by a factor drawn in [1 - amplitude, 1 + amplitude]."""
    scale = uniform(gen, (batch, base.shape[0], 1), 1. - amplitude,
                    1. + amplitude, base.device)
    return base[None] * scale


def ring_eyes(batch, radius, height, gen, device):
    """Eyes evenly spaced on a ring of ``radius`` at ``height``, turned by
    one seeded angle: (batch, 3)."""
    phase = uniform(gen, (1,), 0., 2 * math.pi, device)
    ang = phase + torch.arange(batch, device=device) * (2 * math.pi / batch)
    return torch.stack([radius * torch.sin(ang),
                        torch.full_like(ang, height),
                        radius * torch.cos(ang)], -1)


def image_grid(height, width, device):
    """Pixel-centre coordinates (Y (H, 1), X (1, W)) in [-1, 1], y up."""
    x = (2. * torch.arange(width, device=device) + 1. - width) / width
    y = (height - 2. * torch.arange(height, device=device) - 1.) / height
    return y[:, None], x[None, :]


def fixed_set(gen, batch, device):
    """(a generator of the same draws for every seed, this seed's order of
    the ``batch`` targets)."""
    return generator(0, device), torch.randperm(batch, generator=gen,
                                               device=device)


def smooth_images(batch, channels, height, width, gen, device):
    """(batch, H, W, channels) images in [0, 1]: per image and channel one
    plane wave of fixed direction, frequency and phase, the images in the
    seed's order."""
    Y, X = image_grid(height, width, device)
    fixed, order = fixed_set(gen, batch, device)
    freq = uniform(fixed, (batch, channels, 2), -3 * math.pi, 3 * math.pi,
                   device)[order]
    phase = uniform(fixed, (batch, channels), 0., 2 * math.pi,
                    device)[order]
    arg = (freq[..., 0, None, None] * X + freq[..., 1, None, None] * Y
           + phase[..., None, None])
    return (0.5 + 0.5 * torch.sin(arg)).permute(0, 2, 3, 1).contiguous()


def ellipse_masks(batch, height, width, axes, gen, device):
    """(batch, H, W) silhouettes of ellipses, 1 inside: centre within 0.1
    of the image's, semi-axes in ``axes``, any orientation; a fixed set in
    the seed's order."""
    Y, X = image_grid(height, width, device)
    fixed, order = fixed_set(gen, batch, device)
    centre = uniform(fixed, (batch, 2), -0.1, 0.1, device)[order]
    semi = uniform(fixed, (batch, 2), axes[0], axes[1], device)[order]
    ang = uniform(fixed, (batch,), 0., math.pi, device)[order]
    dx = X - centre[:, 0, None, None]
    dy = Y - centre[:, 1, None, None]
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    u, v = c * dx + s * dy, -s * dx + c * dy
    return ((u / semi[:, 0, None, None]) ** 2
            + (v / semi[:, 1, None, None]) ** 2 <= 1.).float()
