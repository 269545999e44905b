"""Plain PyTorch reference of the DIB-R render paths that the benchmark
times: cameras, face preparation, the z-buffer selection, barycentric
interpolation, the soft silhouette, bilinear texture sampling and the IoU.

Written from the formulas of DIB-R (Chen et al., NeurIPS 2019) and of
kaolin's rasterizer, in plain tensor operations with autograd for the
gradients, but for the interpolation's, which follows kaolin's closed
form (``_Interp``). It imports nothing of the measured package. The z-buffer walks
the (pixel, face) pairs of each face's bounding box, so its cost follows
the faces' area and not pixels x faces.

Conventions (those of the measured package's public API): image
coordinates in [-1, 1], y up; coordinates scaled by ``MULTIPLIER`` for
the pixel tests; the largest interpolated camera-space z wins, ties to
the lowest face id; a pixel centre is inside a box when
``xmin <= x < xmax`` and ``ymin <= y < ymax``.
"""

import torch

MULTIPLIER = 1000.
BARY_EPS = 1e-8          # the barycentric normalisation's guard
SOFT_EPS = 1e-7          # the soft mask's distance guard


def _balanced(x, ans, other):
    half = torch.where(other == ans, 0.5, 1.).to(ans.dtype)
    return torch.where(x == ans, half, torch.zeros_like(half))


class _Clip(torch.autograd.Function):
    """``min(max(x, lo), hi)``; at a tie with a bound half the gradient
    passes (the derivative of max and min taken as their mean)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        m = torch.maximum(x, lo)
        y = torch.minimum(m, hi)
        ctx.save_for_backward(x, lo, hi, m, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, lo, hi, m, y = ctx.saved_tensors
        return (g * _balanced(m, y, hi)) * _balanced(x, m, lo), None, None


def clip(x, lo, hi):
    return _Clip.apply(x, x.new_full((), lo), x.new_full((), hi))


# ---- cameras ---------------------------------------------------------------

def normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def lookat_6dof(eye, at, up):
    """(C, 9) 6-DoF camera parameters (first two rows of the rotation,
    then the translation) of glm's right-handed lookat, -z forward."""
    back = normalize(at - eye)
    right = normalize(torch.linalg.cross(back, up, dim=-1))
    up = torch.linalg.cross(right, back, dim=-1)
    rot = torch.stack([right, up, -back], dim=1)
    t = -(rot @ eye[..., None])[..., 0]
    return torch.cat([rot[:, 0], rot[:, 1], t], dim=-1)


def rotation_6dof(params):
    """(R (C, 3, 3), t (C, 3)) from 6-DoF parameters, by one Gram-Schmidt
    step."""
    a1, a2, t = params[:, 0:3], params[:, 3:6], params[:, 6:9]
    b1 = normalize(a1)
    b2 = normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=1), t


def world_to_camera_6dof(params, vertices):
    rot, t = rotation_6dof(params)
    return (torch.sum(rot[:, None] * vertices[..., None, :], -1)
            + t[:, None])


def lookat_legacy(eye, at, up):
    """(rot (C, 3, 3), eye) of the legacy camera: rows (x, y, -z), points
    moved by ``R (p - eye)``."""
    camz = at - eye
    camz = camz / (torch.linalg.norm(camz, dim=1, keepdim=True) + 1e-10)
    camx = torch.linalg.cross(camz, up, dim=1)
    camx = camx / (torch.linalg.norm(camx, dim=1, keepdim=True) + 1e-10)
    camy = torch.linalg.cross(camx, camz, dim=1)
    camy = camy / (torch.linalg.norm(camy, dim=1, keepdim=True) + 1e-10)
    return torch.stack([camx, camy, -camz], dim=1), eye


def world_to_camera_legacy(rot, trans, vertices):
    return torch.matmul(vertices - trans.reshape(-1, 1, 3),
                        rot.transpose(-1, -2))


def perspective(fovy, dtype, device):
    """(3,) projection vector ``[1/tan(fovy/2), 1/tan(fovy/2), -1]``."""
    import math
    f = 1. / math.tan(fovy / 2.)
    return torch.tensor([f, f, -1.], dtype=dtype, device=device)


def project(points, proj):
    p = points * proj.reshape(1, 1, 3)
    return p[:, :, :2] / p[:, :, 2:3]


def face_normals_unit(fvc):
    n = torch.linalg.cross(fvc[:, :, 1] - fvc[:, :, 0],
                           fvc[:, :, 2] - fvc[:, :, 0], dim=-1)
    return n / (torch.linalg.norm(n, dim=2, keepdim=True) + 1e-10)


# ---- pixels and pairs -------------------------------------------------------

def pixel_centres(height, width, dtype, device, multiplier=MULTIPLIER):
    """Scaled pixel-centre coordinates (x (W,), y (H,)), y up; the scale
    ``multiplier / size`` is formed in double and rounded to ``dtype``."""
    wx = torch.arange(width, dtype=dtype, device=device)
    hy = torch.arange(height, dtype=dtype, device=device)
    sx = torch.tensor(multiplier / width, dtype=dtype, device=device)
    sy = torch.tensor(multiplier / height, dtype=dtype, device=device)
    return sx * (2. * wx + 1. - width), sy * (height - 2. * hy - 1.)


def box_ranges(bbox, x0, y0):
    """Per box (xmin, ymin, xmax, ymax), the pixel rows [r_lo, r_hi) and
    columns [c_lo, c_hi) whose centres it holds."""
    H = y0.numel()
    y_up = y0.flip(0).contiguous()
    c_lo = torch.searchsorted(x0, bbox[..., 0].contiguous())
    c_hi = torch.searchsorted(x0, bbox[..., 2].contiguous())
    r_lo = H - torch.searchsorted(y_up, bbox[..., 3].contiguous())
    r_hi = H - torch.searchsorted(y_up, bbox[..., 1].contiguous())
    return r_lo, r_hi, c_lo, c_hi


def box_pairs(bbox, x0, y0):
    """Every (box, pixel) pair with the pixel's centre in the box: (box
    index into the flattened leading dims, row, column), int64."""
    r_lo, r_hi, c_lo, c_hi = (t.reshape(-1) for t in box_ranges(bbox, x0,
                                                                 y0))
    nr = (r_hi - r_lo).clamp(min=0)
    nc = (c_hi - c_lo).clamp(min=0)
    n = nr * nc
    box = torch.repeat_interleave(torch.arange(n.numel(), device=n.device),
                                  n)
    k = torch.arange(box.numel(), device=n.device) - (torch.cumsum(n, 0)
                                                      - n)[box]
    width = nc[box]
    return box, r_lo[box] + k // width, c_lo[box] + k % width


def barycentric(px, py, img, eps=BARY_EPS):
    ax = img[..., 0] - px
    ay = img[..., 1] - py
    bx = img[..., 2] - px
    by = img[..., 3] - py
    cx = img[..., 4] - px
    cy = img[..., 5] - py
    w0 = bx * cy - by * cx
    w1 = cx * ay - cy * ax
    w2 = ax * by - ay * bx
    norm = w0 + w1 + w2
    norm = norm + torch.copysign(norm.new_tensor(eps), norm)
    return w0 / norm, w1 / norm, w2 / norm


def select_faces(face_z, face_image, valid, height, width,
                 multiplier=MULTIPLIER, eps=BARY_EPS):
    """The z-buffer: per pixel the face whose interpolated z is largest
    among the valid faces holding the pixel centre (barycentrics all >= 0),
    ties to the lowest id; -1 where none. (B, H, W) int64. No gradient."""
    with torch.no_grad():
        B, F = face_z.shape[:2]
        x0, y0 = pixel_centres(height, width, face_z.dtype, face_z.device,
                               multiplier)
        img = (face_image * multiplier).reshape(B * F, 6)
        bbox = torch.cat([img.reshape(B * F, 3, 2).amin(1),
                          img.reshape(B * F, 3, 2).amax(1)], -1)
        if valid is not None:
            empty = bbox.new_tensor([torch.inf, torch.inf, -torch.inf,
                                     -torch.inf])
            bbox = torch.where(valid.reshape(-1, 1), bbox, empty)
        box, row, col = box_pairs(bbox, x0, y0)
        px, py = x0[col], y0[row]
        w0, w1, w2 = barycentric(px, py, img[box], eps)
        z = face_z.reshape(B * F, 3)[box]
        z0 = w0 * z[:, 0] + w1 * z[:, 1] + w2 * z[:, 2]
        ok = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
        pix = ((box // F) * height + row) * width + col
        pix, z0, face = pix[ok], z0[ok], (box % F)[ok]
        zbuf = z0.new_full((B * height * width,), -torch.inf)
        zbuf.scatter_reduce_(0, pix, z0, 'amax')
        win = z0 == zbuf[pix]
        big = F + 1
        idx = torch.full((B * height * width,), big, dtype=torch.int64,
                         device=face_z.device)
        idx.scatter_reduce_(0, pix[win], face[win], 'amin')
        idx[idx == big] = -1
        return idx.reshape(B, height, width)


class _Interp(torch.autograd.Function):
    """Barycentric interpolation at given pixels, with kaolin's analytic
    backward: the derivative of the weights in the face's 6 image
    coordinates in closed (Cramer) form, the pixel taken back from the
    weights, chained with the feature deltas; ``w_i * g`` for the
    features. (Autograd of the forward differs from it by rounding that
    ``1 / k3^2`` magnifies on faces seen edge-on.)"""

    @staticmethod
    def forward(ctx, img, feat, px, py, multiplier, eps):
        w = torch.stack(barycentric(px, py, img * multiplier, eps), -1)
        ctx.save_for_backward(img, feat, w)
        ctx.eps = eps
        return (w[:, 0, None] * feat[:, 0] + w[:, 1, None] * feat[:, 1]
                + w[:, 2, None] * feat[:, 2])

    @staticmethod
    def backward(ctx, g):
        img, feat, w = ctx.saved_tensors
        aw, bw, cw = w.unbind(-1)
        ax, ay, bx, by, cx, cy = img.unbind(-1)
        c0, c1, c2 = feat.unbind(1)
        x0 = aw * ax + bw * bx + cw * cx
        y0 = aw * ay + bw * by + cw * cy
        m, p, n, q = bx - ax, by - ay, cx - ax, cy - ay
        s, t = x0 - ax, y0 - ay
        k1 = s * q - n * t
        k2 = m * t - s * p
        k3 = m * q - n * p
        k3 = k3 + torch.copysign(k3.new_tensor(ctx.eps), k3)
        # d(k1 / k3) and d(k2 / k3), times k3^2, in m, n, p, q, s, t
        d1 = dict(m=-q * k1, n=-t * k3 + p * k1, p=n * k1,
                  q=s * k3 - m * k1, s=q * k3, t=-n * k3)
        d2 = dict(m=t * k3 - q * k2, n=p * k2, p=-s * k3 + n * k2,
                  q=-m * k2, s=-p * k3, t=m * k3)
        g1 = (g * (c1 - c0)).sum(-1) / (k3 * k3)
        g2 = (g * (c2 - c0)).sum(-1) / (k3 * k3)

        def total(key):
            return g1 * d1[key] + g2 * d2[key]

        dax = (g1 * -(d1['m'] + d1['n'] + d1['s'])
               + g2 * -(d2['m'] + d2['n'] + d2['s']))
        day = (g1 * -(d1['p'] + d1['q'] + d1['t'])
               + g2 * -(d2['p'] + d2['q'] + d2['t']))
        grad_img = torch.stack([dax, day, total('m'), total('p'),
                                total('n'), total('q')], -1)
        grad_feat = w[..., None] * g[:, None]
        return grad_img, grad_feat, None, None, None, None


def interpolate(face_idx, face_image, face_features, multiplier=MULTIPLIER,
                eps=BARY_EPS):
    """(B, H, W, D) features of each pixel's face, by its barycentrics,
    differentiable in the image coordinates and the features; 0 where no
    face."""
    B, H, W = face_idx.shape
    F, D = face_image.shape[1], face_features.shape[-1]
    x0, y0 = pixel_centres(H, W, face_image.dtype, face_image.device,
                           multiplier)
    b, pix = (face_idx.reshape(B, -1) >= 0).nonzero(as_tuple=True)
    f = face_idx.reshape(B, -1)[b, pix]
    img = face_image.reshape(B, F, 6)[b, f]
    val = _Interp.apply(img, face_features[b, f], x0[pix % W], y0[pix // W],
                        multiplier, eps)
    out = face_image.new_zeros((B, H * W, D))
    return out.index_put((b, pix), val).reshape(B, H, W, D)


def _min6(px, py, img, multiplier):
    """Least of the squared distances from the pixel to the 3 edges (where
    the foot of the perpendicular falls inside the edge; else 4 m^2) and
    to the 3 vertices."""
    bad = 4. * multiplier * multiplier
    ds = []
    for i in range(3):
        j = (i + 1) % 3
        x1, y1 = img[..., 2 * i], img[..., 2 * i + 1]
        x2, y2 = img[..., 2 * j], img[..., 2 * j + 1]
        a = y2 - y1
        b = x1 - x2
        c = x2 * y1 - x1 * y2
        up = a * px + b * py + c
        down = a * a + b * b
        x3 = (b * b * px - a * b * py - a * c) / (down + SOFT_EPS)
        y3 = (a * a * py - a * b * px - b * c) / (down + SOFT_EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        ds.append(torch.where(direct > 0, torch.full_like(up, bad),
                              up * up / (down + SOFT_EPS)))
    for i in range(3):
        dx = px - img[..., 2 * i]
        dy = py - img[..., 2 * i + 1]
        ds.append(dx * dx + dy * dy)
    d = ds[0]
    for e in ds[1:]:
        d = torch.where(e < d, e, d)
    return d


def soft_mask(face_image, face_idx, sigmainv, boxlen, knum,
              multiplier=MULTIPLIER):
    """DIB-R's soft silhouette (B, H, W): 1 on covered pixels; on the
    others ``1 - prod(1 - exp(-sigmainv d^2))`` over the first ``knum``
    faces, in face order, whose box enlarged by ``boxlen`` holds the pixel
    centre, ``d`` the pixel's distance to the face. Differentiable in the
    image coordinates."""
    B, H, W = face_idx.shape
    F = face_image.shape[1]
    x0, y0 = pixel_centres(H, W, face_image.dtype, face_image.device,
                           multiplier)
    img = (face_image * multiplier).reshape(B * F, 6)
    uncovered = (face_idx < 0).reshape(-1)
    with torch.no_grad():
        pts = img.detach().reshape(B * F, 3, 2)
        margin = boxlen * multiplier
        bbox = torch.cat([pts.amin(1) - margin, pts.amax(1) + margin], -1)
        box, row, col = box_pairs(bbox, x0, y0)
        pix = ((box // F) * H + row) * W + col
        keep = uncovered[pix]
        box, row, col, pix = box[keep], row[keep], col[keep], pix[keep]
        order = torch.argsort(pix * F + box % F)
        box, row, col, pix = box[order], row[order], col[order], pix[order]
        n = pix.numel()
        first = torch.ones(n, dtype=torch.bool, device=pix.device)
        first[1:] = pix[1:] != pix[:-1]
        pos = torch.arange(n, device=pix.device)
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = pos - start
        keep = rank < knum
        box, row, col, pix, rank = (box[keep], row[keep], col[keep],
                                    pix[keep], rank[keep])
        slot_pix, slot = torch.unique(pix, return_inverse=True)
    d = _min6(x0[col], y0[row], img[box], multiplier)
    m = img.new_tensor(multiplier)
    p = torch.exp(-(sigmainv * d / m / m))
    factors = img.new_ones((slot_pix.numel(), max(knum, 1)))
    factors = factors.index_put((slot, rank), 1. - p)
    mask = img.new_ones((B * H * W,))
    mask = torch.where(uncovered, img.new_zeros(()), mask)
    mask = mask.index_put((slot_pix,), 1. - torch.prod(factors, dim=1))
    return mask.reshape(B, H, W)


def mask_iou_terms(lhs, rhs):
    """Per image, ``intersection / union`` of two soft masks (B,)."""
    B = lhs.shape[0]
    mul = lhs * rhs
    up = mul.reshape(B, -1).sum(1)
    down = (lhs + rhs - mul).reshape(B, -1).sum(1)
    return up / (down + 1e-10)


def bilinear(uv_map, texture):
    """Bilinear samples (B, h, w, C) of ``texture`` (B, C, Ht, Wt) at UVs
    (B, h, w, 2) in [0, 1], v up; texel centres at half-integers, borders
    clamped."""
    B, C, Ht, Wt = texture.shape
    uv = clip(uv_map.reshape(B, -1, 2), 0., 1.) * 2. - 1.
    x, y = uv[..., 0], uv[..., 1] * -1.
    ix = clip(((x + 1.) * Wt - 1.) / 2., 0., Wt - 1.)
    iy = clip(((y + 1.) * Ht - 1.) / 2., 0., Ht - 1.)
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0f)[..., None], (iy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(max=Wt - 1), (y0 + 1).clamp(max=Ht - 1)
    flat = texture.flatten(2)

    def tap(yy, xx):
        idx = (yy * Wt + xx)[:, None, :].expand(B, C, yy.shape[1])
        return torch.gather(flat, 2, idx).transpose(1, 2)

    out = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
           + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)
    return out.reshape(uv_map.shape[:-1] + (C,))
