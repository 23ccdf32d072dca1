"""
DL4DS on PyTorch and CUDA: the port of `dl4ds_tpu` to NVIDIA Hopper.

The package keeps the JAX package's public vocabulary (registries, factory
names, `predict`) and its NHWC layout at every public function, so the same
inputs and weights can be fed through both. The hot kernels that the JAX
package wrote in Pallas are written by hand in CUDA C++ (`csrc/`), built
with `nvcc` at first use and launched on PyTorch's current stream.

Entry points (`predict`, `SupervisedTrainer`) run on the GPU unless the
caller passes `device='cpu'`.
"""

__version__ = "0.1.0"

# Registries: the same canonical vocabulary as the JAX package
BACKBONE_BLOCKS = [
    'convnet',          # plain convolutional blocks w/o skip connections
    'resnet',           # residual convolutional blocks
    'densenet',         # dense convolutional blocks
    'convnext',         # convnext-style residual blocks
    'unet']             # unet (encoder-decoder) backbone

UPSAMPLING_METHODS = [
    'spc',              # sub-pixel convolution (pixel shuffle), post-upsampling
    'rc',               # resize convolution, post-upsampling
    'dc',               # deconvolution (transposed convolution), post-upsampling
    'pin']              # pre-upsampling via interpolation
POSTUPSAMPLING_METHODS = ['spc', 'rc', 'dc']

INTERPOLATION_METHODS = [
    'inter_area',       # resampling using pixel-area relation
    'nearest',          # nearest-neighbour interpolation
    'bicubic',          # bicubic interpolation (a=-0.75, OpenCV convention)
    'bilinear',         # bilinear interpolation
    'lanczos']          # Lanczos interpolation over an 8x8 neighbourhood

LOSS_FUNCTIONS = [
    'mae',              # mean absolute error
    'mse',              # mean squared error
    'dssim',            # structural dissimilarity
    'dssim_mae',        # 0.8 * DSSIM + 0.2 * MAE
    'dssim_mse',        # 0.8 * DSSIM + 0.2 * MSE
    'dssim_mae_mse',    # 0.6 * DSSIM + 0.2 * MAE + 0.2 * MSE
    'msdssim',          # multiscale structural dissimilarity
    'msdssim_mae',      # 0.8 * MSDSSIM + 0.2 * MAE
    'msdssim_mae_mse']  # 0.6 * MSDSSIM + 0.2 * MAE + 0.2 * MSE

DROPOUT_VARIANTS = [
    'vanilla',          # vanilla dropout
    'gaussian',         # gaussian (multiplicative noise) dropout
    'spatial',          # spatial (whole-channel) dropout
    'mcdrop',           # monte-carlo vanilla dropout (active at inference)
    'mcgaussiandrop',   # monte-carlo gaussian dropout
    'mcspatialdrop']    # monte-carlo spatial dropout

from .interpolation import resize2d, resize_matrix
from .utils import (checkarray_ndim, Timing, checkarg_upsampling,
                    checkarg_backbone, checkarg_dropout_variant)
from .ops import (depth_to_space, fused_channel_attention,
                  channel_attention_reference, fused_convlstm,
                  convlstm_reference, fused_ssim_per_image)
from . import losses
from .losses import (mae, mse, dssim, dssim_mae, dssim_mse, dssim_mae_mse,
                     msdssim, msdssim_mae, msdssim_mae_mse)
from .dataloader import BatchSynthesizer
from .models import (DSModel, build_model, net_postupsampling,
                     recnet_postupsampling)
from .weights import load_jax_params
from .inference import Predictor, predict
from .training import SupervisedTrainer
