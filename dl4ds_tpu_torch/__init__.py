"""
DL4DS on PyTorch and CUDA: the port of `dl4ds_tpu` to NVIDIA Hopper.

The package keeps the JAX package's public vocabulary (registries, factory
names, `predict`) and its NHWC layout at every public function, so the same
inputs and weights can be fed through both. The hot kernels that the JAX
package wrote in Pallas are written by hand in CUDA C++ (`csrc/`), built
with `nvcc` at first use and launched on PyTorch's current stream.

Entry points (`predict`, `SupervisedTrainer`, `CGANTrainer`,
`compute_metrics`) run on
the GPU unless the caller passes `device='cpu'`. The spatial models take
the convnet, resnet, densenet and ConvNeXt backbones with the sub-pixel,
resize or transposed-convolution head, or the pre-upsampled input
('pin', `net_pin` and the U-Net `unet_pin`); the spatio-temporal
(ConvLSTM) models the convnet, resnet and densenet merges with the same
heads (`recnet_postupsampling`) or the pre-upsampled input
(`recnet_pin`); every model takes batch or
layer normalization, each dropout variant and the localized output
layer, and `predict_mc` serves an 'mc*' dropout model as a Monte-Carlo
ensemble. Both of DL4DS's training modes run: PerfectProg (HR data
alone, coarsened on the device) and MOS (given LR/HR pairs,
`data_train_lr=`, served by `predict(array_in_hr=False)`), with season
channels from time metadata. `CGANTrainer` trains a generator of the zoo
against the two-branch `residual_discriminator` (pix2pix-style), one fused
G+D step at a time. Batches are built on the device from a dataset held
there, or with `data_in_hbm=False` streamed from host RAM or a memmapped
file (`HostStreamer`: the native gather/crop into pinned slots, copied
to the card behind the step); the reference's host tier
(`create_pair_hr_lr`, `create_batch_hr_lr`, `DataGenerator`) is numpy.
A trained model is frozen for serving by `save_serving_artifact`
(`torch.export`, the kernels kept as operator nodes) and served over HTTP
by `python -m dl4ds_tpu_torch.serve --artifact DIR` (`serve.ModelServer`).
Int8 post-training quantization (`quantize_forward`; `quantize=` in
`predict`, tiled `predict` and the artifacts) runs every convolution
through the hand-written int8 convolution (K7, `csrc/conv_int8.cu`).
The command-line app `python -m dl4ds_tpu_torch.app --flagfile=F` reads
the JAX app's flag files; reference Keras checkpoints load with
`import_keras_weights` (`init_weights=` in the trainers); `viz` draws the
interactive and projected maps; `ops.flops.count_flops` counts a call's
matmul and convolution FLOPs, the hand-written kernels' included, alike
on the CPU and the card. `SupervisedTrainer(mesh=distributed.global_mesh())`
trains data-parallel over processes, one a device (`torchrun
--nproc_per_node=N`; NCCL on the GPU, gloo only with device='cpu').
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

from .interpolation import resize2d, resize_array, resize_matrix
from .utils import (crop_array, checkarray_ndim, Timing,
                    spatial_to_spatiotemporal_samples,
                    spatiotemporal_to_spatial_samples,
                    check_compatibility_upsbackb, checkarg_upsampling,
                    checkarg_backbone, checkarg_dropout_variant,
                    checkarg_loss, checkarg_interpolation, list_devices,
                    plot_history)
from .viz import interactive_panel, plot_projected
from .ops import (depth_to_space, fused_channel_attention,
                  channel_attention_reference, fused_convlstm,
                  convlstm_reference, fused_ssim_per_image)
from . import losses
from .losses import (mae, mse, dssim, dssim_mae, dssim_mse, dssim_mae_mse,
                     msdssim, msdssim_mae, msdssim_mae_mse)
from .preprocessing import MinMaxScaler, StandardScaler
from .dataloader import (create_pair_hr_lr, create_batch_hr_lr, DataGenerator,
                         BatchSynthesizer, HostStreamer, _get_season_,
                         _get_season_array_)
from .models import (DSModel, build_model, net_postupsampling, net_pin,
                     unet_pin, recnet_postupsampling, recnet_pin,
                     residual_discriminator, save_model, load_model)
from .models.blocks import (Dropout, get_dropout_layer, MCDropout,
                            MCGaussianDropout, MCSpatialDropout2D,
                            MCSpatialDropout3D, DropPath, ConvNextBlock,
                            LocalizedConvBlock, use_dropout_generator)
from .weights import load_jax_params
from .inference import Predictor, predict, predict_mc
from .export import (export_forward, save_serving_artifact,
                     load_serving_artifact)
from .quantization import quantize_forward
from .training import (Trainer, SupervisedTrainer, CGANTrainer,
                       load_checkpoint, train_step)
from .metrics import (compute_rmse, compute_correlation, compute_metrics,
                      crps_ensemble, spread_skill, rank_histogram,
                      compute_prob_metrics)
from . import compat
from .compat import import_keras_weights
from . import distributed
