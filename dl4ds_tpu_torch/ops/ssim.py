"""
SSIM, multiscale SSIM and PSNR in plain PyTorch (the counterpart of
`dl4ds_tpu/ops/ssim.py`), with tf.image semantics: an 11x11 separable
Gaussian window of sigma 1.5, VALID padding, statistics as E[xy] - E[x]E[y]
of the filtered images, per-channel SSIM averaged over space and channels;
MS-SSIM with relu-ed contrast-structure terms, 2x average pooling after a
symmetric pad to even sizes, and a weighted geometric mean.

The filtering is two float32 (or float64) matmuls against banded matrices,
as in the JAX package, with TF32 off whatever the caller set: sigma^2 =
E[x^2] - mu^2 cancels, which is why the JAX package pins HIGHEST precision
there. `ssim` is the plain version of K6's forward, the fused SSIM kernel
(`ops/fused_ops.py` `fused_ssim_per_image`), and `ssim_backward_reference`
the plain version of its backward, the closed form of the VJP; float64
inputs stay float64, so that they can be the kernels' oracles on the card.
`ssim_multiscale` runs this formulation on every device, as the JAX
package runs XLA there.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .convlstm import _fp32_matmuls

__all__ = ['ssim', 'ssim_backward_reference', 'ssim_multiscale', 'psnr',
           'band_matrix']

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel1d(size, sigma):
    """Normalised Gaussian taps, formed in float64 and rounded to float32
    (dl4ds_tpu/ops/ssim.py:28-31)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def band_matrix(kernel1d, n):
    """(n-k+1, n) banded matrix applying a 1-D VALID filter
    (dl4ds_tpu/ops/ssim.py:34-42)."""
    k = kernel1d.shape[0]
    m = np.zeros((n - k + 1, n), dtype=np.float32)
    for i in range(n - k + 1):
        m[i, i:i + k] = kernel1d
    return m


@functools.lru_cache(maxsize=64)
def _band(taps, n, dtype, device):
    """The band matrix of the float32 taps (bytes) for length n, as a tensor
    on `device`, built once: a copy to the card per call would stall the
    host."""
    kernel1d = np.frombuffer(taps, dtype=np.float32)
    return torch.from_numpy(band_matrix(kernel1d, n)).to(device=device,
                                                         dtype=dtype)


def _filter_valid(x, kernel1d):
    """Separable VALID 2-D filtering over the (-3, -2) spatial axes of
    [..., H, W, C], as two windowed matmuls with band matrices."""
    k = kernel1d.shape[0]
    h, w = x.shape[-3], x.shape[-2]
    if h < k or w < k:
        raise ValueError(
            f'image ({h}x{w}) is smaller than the {k}x{k} SSIM filter '
            f'window (tf.image semantics; for MS-SSIM every scale must '
            f'stay >= the window)')
    taps = kernel1d.tobytes()
    with _fp32_matmuls():
        y = torch.tensordot(x, _band(taps, h, x.dtype, x.device),
                            dims=([-3], [1]))
        y = torch.movedim(y, -1, -3)
        y = torch.tensordot(y, _band(taps, w, x.dtype, x.device),
                            dims=([-2], [1]))
    return torch.movedim(y, -1, -2)


def _filter_valid_t(d, kernel1d, h, w):
    """The transpose of `_filter_valid`: [..., Hv, Wv, C] maps back to
    [..., H, W, C], through the transposed band matrices (the full
    correlation with the taps reversed)."""
    taps = kernel1d.tobytes()
    with _fp32_matmuls():
        y = torch.tensordot(d, _band(taps, h, d.dtype, d.device),
                            dims=([-3], [0]))
        y = torch.movedim(y, -1, -3)
        y = torch.tensordot(y, _band(taps, w, d.dtype, d.device),
                            dims=([-2], [0]))
    return torch.movedim(y, -1, -2)


def _ssim_per_channel(img1, img2, max_val, filter_size, filter_sigma, k1, k2):
    """(ssim, cs) per image and channel: means over the VALID window
    positions, shape [..., C]. The five filtered moments (mu1, mu2, E[x^2],
    E[y^2], E[xy]) are stacked and filtered together."""
    kernel = _gaussian_kernel1d(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    stacked = torch.stack(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    mu1, mu2, mu11, mu22, mu12 = _filter_valid(stacked, kernel)

    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = mu11 - mu1_sq
    sigma2_sq = mu22 - mu2_sq
    sigma12 = mu12 - mu1_mu2

    luminance = (2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = luminance * cs
    dims = (-3, -2)
    return ssim_map.mean(dim=dims), cs.mean(dim=dims)


def _as_float(img):
    """float64 stays float64 (the kernel's oracle); anything else is
    computed in float32, as the JAX package does."""
    img = torch.as_tensor(img)
    return img if img.dtype == torch.float64 else img.to(torch.float32)


def ssim(img1, img2, max_val, filter_size=11, filter_sigma=1.5, k1=0.01,
         k2=0.03):
    """Structural similarity per image of NHWC (or [..., H, W, C]) inputs.
    Returns shape [...] (channel-averaged), like tf.image.ssim. `max_val`
    is a number or a 0-d tensor."""
    s, _ = _ssim_per_channel(_as_float(img1), _as_float(img2), max_val,
                             filter_size, filter_sigma, k1, k2)
    return s.mean(dim=-1)


def ssim_backward_reference(img1, img2, max_val, g, filter_size=11,
                            filter_sigma=1.5, k1=0.01, k2=0.03,
                            need=(True, True, True)):
    """The gradients (img1, img2, max_val) of sum(g * ssim(img1, img2,
    max_val)) for g of ssim's shape [...], None where `need` does not ask,
    in closed form: per valid position, with L = A1/B1, C = A2/B2 (the
    luminance and contrast-structure terms of `_ssim_per_channel`) and S =
    L C, the derivatives of S in mu12 (2L/B2), mu11 and mu22 (-S/B2), mu1
    and mu2, c1 (C(1 - L)/B1) and c2 (L(1 - C)/B2), each times g / (C_img Hv
    Wv); the moment maps then go back through the transposed filter and the
    chain rule of x, y, x^2, y^2, xy, and max_val's through c1 = (k1
    max_val)^2 and c2. The plain version of K6's backward kernel; float64
    stays float64."""
    img1, img2 = _as_float(img1), _as_float(img2)
    dtype = img1.dtype
    kernel = _gaussian_kernel1d(filter_size, filter_sigma)
    mv = torch.as_tensor(max_val).detach().to(device=img1.device, dtype=dtype)
    c1 = (k1 * mv) ** 2
    c2 = (k2 * mv) ** 2

    stacked = torch.stack(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    mu1, mu2, mu11, mu22, mu12 = _filter_valid(stacked, kernel)
    b1 = mu1 * mu1 + mu2 * mu2 + c1
    b2 = (mu11 - mu1 * mu1) + (mu22 - mu2 * mu2) + c2
    lum = (2.0 * mu1 * mu2 + c1) / b1
    cs = (2.0 * (mu12 - mu1 * mu2) + c2) / b2
    *lead, h, w, c = img1.shape
    hv, wv = mu1.shape[-3], mu1.shape[-2]
    scale = torch.as_tensor(g).detach().to(device=img1.device, dtype=dtype)
    scale = scale.reshape(*lead, 1, 1, 1) / (c * hv * wv)

    d1 = d2 = dmv = None
    if need[0] or need[1]:
        d_mu1 = (2.0 * cs * (mu2 - lum * mu1) / b1
                 + 2.0 * lum * (cs * mu1 - mu2) / b2)
        d_mu2 = (2.0 * cs * (mu1 - lum * mu2) / b1
                 + 2.0 * lum * (cs * mu2 - mu1) / b2)
        maps = torch.stack([d_mu1, d_mu2, -lum * cs / b2, 2.0 * lum / b2],
                           dim=0) * scale
        u1, u2, u11, u12 = _filter_valid_t(maps, kernel, h, w)
        if need[0]:
            d1 = u1 + 2.0 * img1 * u11 + img2 * u12
        if need[1]:
            d2 = u2 + 2.0 * img2 * u11 + img1 * u12
    if need[2]:
        dmv = (scale * (cs * (1.0 - lum) / b1 * (2.0 * k1 * k1 * mv)
                        + lum * (1.0 - cs) / b2 * (2.0 * k2 * k2 * mv))).sum()
    return d1, d2, dmv


def _downsample_2x(x):
    """Symmetric pad to even spatial sizes, then a 2x2 VALID average pool,
    tf.image.ssim_multiscale's reduction between scales. A symmetric pad of
    one row or column repeats the last one."""
    h, w = x.shape[-3], x.shape[-2]
    if h % 2:
        x = torch.cat([x, x[..., -1:, :, :]], dim=-3)
    if w % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    h, w = x.shape[-3], x.shape[-2]
    lead = x.shape[:-3]
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, x.shape[-1])
    return x.mean(dim=(-4, -2))


def ssim_multiscale(img1, img2, max_val, power_factors=_MSSSIM_WEIGHTS,
                    filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """Multiscale SSIM per image (tf.image.ssim_multiscale semantics)."""
    img1, img2 = _as_float(img1), _as_float(img2)
    n_scales = len(power_factors)
    mcs = []
    val = None
    for k in range(n_scales):
        s, cs = _ssim_per_channel(img1, img2, max_val, filter_size,
                                  filter_sigma, k1, k2)
        if k < n_scales - 1:
            mcs.append(F.relu(cs))
            img1 = _downsample_2x(img1)
            img2 = _downsample_2x(img2)
        else:
            val = F.relu(s)
    result = val ** power_factors[-1]
    for w_k, cs_k in zip(power_factors[:-1], mcs):
        result = result * (cs_k ** w_k)
    return result.mean(dim=-1)


def psnr(img1, img2, max_val):
    """Peak signal-to-noise ratio per image, like tf.image.psnr."""
    img1, img2 = _as_float(img1), _as_float(img2)
    mse = ((img1 - img2) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10((max_val ** 2) / mse)
