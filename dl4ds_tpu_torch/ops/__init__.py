"""Tensor ops of the port: pixel shuffle, SSIM and the fused kernels."""

from .array import depth_to_space
from .fused_ops import (fused_channel_attention, channel_attention_reference,
                        FusedChannelAttention, fused_ssim_per_image, FusedSSIM)
from .ssim import ssim, ssim_multiscale, psnr
from .convlstm import (fused_convlstm, convlstm_reference,
                       convlstm_train_reference, convlstm_backward_reference,
                       convlstm_seq_reference, convlstm_backward_tail,
                       dispatch_info, FusedConvLSTM)

__all__ = ['depth_to_space', 'fused_channel_attention',
           'channel_attention_reference', 'FusedChannelAttention',
           'fused_convlstm', 'convlstm_reference', 'convlstm_train_reference',
           'convlstm_backward_reference', 'convlstm_seq_reference',
           'convlstm_backward_tail', 'dispatch_info', 'FusedConvLSTM',
           'fused_ssim_per_image', 'FusedSSIM', 'ssim', 'ssim_multiscale',
           'psnr']
