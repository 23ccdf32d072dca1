"""Tensor ops of the port: pixel shuffle, SSIM, the fused kernels, the
int8 convolution (the module `conv_int8`, whose import registers the
operator `dl4ds_tpu_torch::conv_int8`) and `count_flops` (`flops`)."""

from .array import depth_to_space
from .fused_ops import (fused_channel_attention, channel_attention_reference,
                        FusedChannelAttention, fused_ssim_per_image, FusedSSIM)
from .ssim import ssim, ssim_multiscale, psnr
from .convlstm import (fused_convlstm, convlstm_reference,
                       convlstm_train_reference, convlstm_backward_reference,
                       convlstm_seq_reference, convlstm_backward_tail,
                       dispatch_info, FusedConvLSTM)
from . import conv_int8
from .flops import count_flops

__all__ = ['depth_to_space', 'fused_channel_attention',
           'channel_attention_reference', 'FusedChannelAttention',
           'fused_convlstm', 'convlstm_reference', 'convlstm_train_reference',
           'convlstm_backward_reference', 'convlstm_seq_reference',
           'convlstm_backward_tail', 'dispatch_info', 'FusedConvLSTM',
           'fused_ssim_per_image', 'FusedSSIM', 'ssim', 'ssim_multiscale',
           'psnr', 'conv_int8', 'count_flops']
