"""Spherical gaussians lighting: distribution, warping, fresnel,
specular/diffuse reflectance, inner products. Port of
``kaolin_tpu/render/lighting/sg.py`` (reference
``kaolin/render/lighting/sg.py:36-511``).

The JAX package has no kernel here: the reduced inner product is a
broadcast and a sum, over chunks of lights so that memory stays
O(num_sg x chunk), and autograd gives the backward. So is the port's, on
the inputs' device.
"""

import math

import torch

__all__ = [
    'sg_distribution_term',
    'sg_warp_distribution',
    'fresnel',
    'sg_warp_specular_term',
    'cosine_lobe_sg',
    'approximate_sg_integral',
    'sg_irradiance_fitted',
    'sg_diffuse_fitted',
    'sg_irradiance_inner_product',
    'sg_diffuse_inner_product',
    'unbatched_sg_inner_product',
    'unbatched_reduced_sg_inner_product',
]


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _reflect(direction, normal):
    return direction - 2 * _dot(direction, normal) * normal


def _ggx_v1(m2, nDotX):
    return 1. / (nDotX + torch.sqrt(m2 + (1. - m2) * nDotX * nDotX))


def sg_distribution_term(direction, roughness):
    """SG approximation of the Trowbridge-Reitz (GGX) distribution.

    Reference: ``kaolin/render/lighting/sg.py:51``.
    """
    m2 = roughness * roughness
    sharpness = 2. / m2
    amplitude = (1. / (math.pi * m2))[:, None].expand(direction.shape)
    return amplitude, direction, sharpness


def sg_warp_distribution(amplitude, direction, sharpness, view):
    """Warps SG lobes toward the current BRDF slice (Wang et al.).

    Reference: ``kaolin/render/lighting/sg.py:81``.
    """
    warp_direction = _reflect(-view, direction)
    warp_sharpness = sharpness / (
        4. * torch.clamp(_dot(direction, view)[..., 0], min=1e-4))
    return amplitude, warp_direction, warp_sharpness


def fresnel(ldh, spec_albedo):
    """Schlick fresnel (``sg.py:120``)."""
    powTerm = (1. - ldh) ** 5
    return spec_albedo + (1. - spec_albedo) * powTerm


def sg_warp_specular_term(amplitude, direction, sharpness, normal,
                          roughness, view, spec_albedo):
    """Cook-Torrance specular reflectance from SG lights.

    Reference: ``kaolin/render/lighting/sg.py:124``.
    """
    ndf_a, ndf_d, ndf_s = sg_distribution_term(normal, roughness)
    ndf_a, ndf_d, ndf_s = sg_warp_distribution(ndf_a, ndf_d, ndf_s, view)
    ndl = torch.clamp(_dot(normal, ndf_d), 0., 1.)
    ndv = torch.clamp(_dot(normal, view), 0., 1.)
    h = ndf_d + view
    h = h / torch.sqrt(_dot(h, h))
    ldh = torch.clamp(_dot(ndf_d, h), 0., 1.)
    output = unbatched_reduced_sg_inner_product(
        ndf_a, ndf_d, ndf_s, amplitude, direction, sharpness)
    m2 = (roughness * roughness)[:, None]
    output = output * _ggx_v1(m2, ndl) * _ggx_v1(m2, ndv)
    output = output * fresnel(ldh, spec_albedo)
    output = output * ndl
    return torch.clamp(output, min=0.)


def cosine_lobe_sg(direction):
    """Clamped-cosine lobe as an SG (``sg.py:184``)."""
    amplitude = torch.full_like(direction, 1.17)
    sharpness = torch.full_like(direction[:, 0], 2.133)
    return amplitude, direction, sharpness


def approximate_sg_integral(amplitude, sharpness):
    """Approximate SG integral (``sg.py:205``)."""
    return 2. * math.pi * (amplitude / sharpness[..., None])


def sg_irradiance_fitted(amplitude, direction, sharpness, normal):
    """Fitted-polynomial irradiance per (point, SG) (``sg.py:220``)."""
    mu_n = torch.einsum('ik,jk->ij', normal, direction)
    lbda = sharpness[None, :]
    c0 = 0.36
    c1 = 1. / (4. * c0)
    eml = torch.exp(-lbda)
    em2l = eml * eml
    rl = 1. / lbda
    scale = 1. + 2. * em2l - rl
    bias = (eml - em2l) * rl - em2l
    x = torch.sqrt(1. - scale)
    x0 = c0 * mu_n
    x1 = c1 * x
    n = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, n * n / x,
                    torch.clamp(mu_n, 0., 1.))
    result = scale * y + bias
    return result[..., None] * approximate_sg_integral(
        amplitude, sharpness)[None]


def sg_diffuse_fitted(amplitude, direction, sharpness, normal, albedo):
    """Lambertian diffuse with the fitted irradiance (``sg.py:279``)."""
    brdf = albedo / math.pi
    return torch.clamp(
        sg_irradiance_fitted(amplitude, direction, sharpness,
                             normal).mean(1), min=0.) * brdf


def sg_irradiance_inner_product(amplitude, direction, sharpness, normal):
    """Irradiance via SG inner product with a cosine lobe (``sg.py:318``)."""
    la, ld, ls = cosine_lobe_sg(normal)
    return torch.clamp(unbatched_reduced_sg_inner_product(
        la, ld, ls, amplitude, direction, sharpness), min=0.)


def sg_diffuse_inner_product(amplitude, direction, sharpness, normal,
                             albedo):
    """DIB-R++ diffuse reflectance (``sg.py:351``)."""
    brdf = albedo / math.pi
    return sg_irradiance_inner_product(amplitude, direction, sharpness,
                                       normal) * brdf


def unbatched_sg_inner_product(amplitude, direction, sharpness,
                               other_amplitude, other_direction,
                               other_sharpness):
    """Pairwise SG inner products, (num_sg, num_other, 3).

    Reference: ``kaolin/render/lighting/sg.py:392``. Antipodal lobes of
    equal sharpness give 0 / 0 (NaN), as in the JAX package.
    """
    ns = amplitude.shape[0]
    no = other_amplitude.shape[0]
    a = amplitude.reshape(ns, 1, 3)
    d = direction.reshape(ns, 1, 3)
    s = sharpness.reshape(ns, 1, 1)
    oa = other_amplitude.reshape(1, no, 3)
    od = other_direction.reshape(1, no, 3)
    os_ = other_sharpness.reshape(1, no, 1)
    dm = s * d + os_ * od
    dm = torch.sqrt(_dot(dm, dm))
    lm = s + os_
    expo = torch.exp(dm - lm) * (a * oa)
    other = 1.0 - torch.exp(-2.0 * dm)
    return 2.0 * math.pi * expo * other / dm


def unbatched_reduced_sg_inner_product(amplitude, direction, sharpness,
                                       other_amplitude, other_direction,
                                       other_sharpness, chunk=512):
    """Sum over the 'other' SGs of the pairwise inner product.

    Reference: ``kaolin/render/lighting/sg.py:472`` (a CUDA kernel there).
    As in the JAX package, the lights are padded to a multiple of
    ``chunk`` (amplitude 0, direction and sharpness 1) and summed chunk
    after chunk into the (num_sg, 3) result, so memory stays
    O(num_sg x chunk); with ``chunk`` or fewer lights there is one sum.
    """
    no = other_amplitude.shape[0]
    if no <= chunk:
        return unbatched_sg_inner_product(
            amplitude, direction, sharpness, other_amplitude,
            other_direction, other_sharpness).sum(1)
    pad = (-no) % chunk
    oa = torch.nn.functional.pad(other_amplitude, (0, 0, 0, pad))
    od = torch.nn.functional.pad(other_direction, (0, 0, 0, pad),
                                 value=1.)   # dummy direction, zero amplitude
    os_ = torch.nn.functional.pad(other_sharpness, (0, pad), value=1.)
    acc = torch.zeros_like(amplitude)
    for k in range(0, no + pad, chunk):
        acc = acc + unbatched_sg_inner_product(
            amplitude, direction, sharpness, oa[k:k + chunk],
            od[k:k + chunk], os_[k:k + chunk]).sum(1)
    return acc
