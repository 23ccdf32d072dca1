"""Pixel shuffle in the JAX package's NHWC channel order.

`torch.pixel_shuffle` reads the input channels as (c, dy, dx); the JAX
package (and TensorFlow's depth_to_space, which the reference model used)
reads them as (dy, dx, c). Weights carried over from the JAX package only
give the same output with the (dy, dx, c) order, so it is written out here.
"""

__all__ = ['depth_to_space']


def depth_to_space(x, block_size):
    """[..., H, W, C*r^2] -> [..., H*r, W*r, C] (NHWC, r = block_size)."""
    r = block_size
    *lead, h, w, c = x.shape
    if c % (r * r) != 0:
        raise ValueError(f'channels {c} not divisible by block_size^2 {r * r}')
    c_out = c // (r * r)
    x = x.reshape(*lead, h, w, r, r, c_out)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h * r, w * r, c_out)
