"""Tensor ops of the port: pixel shuffle and the fused kernels."""

from .array import depth_to_space
from .fused_ops import (fused_channel_attention, channel_attention_reference,
                        FusedChannelAttention)
from .convlstm import (fused_convlstm, convlstm_reference,
                       convlstm_train_reference, convlstm_backward_reference,
                       convlstm_seq_reference, convlstm_backward_tail,
                       dispatch_info, FusedConvLSTM)

__all__ = ['depth_to_space', 'fused_channel_attention',
           'channel_attention_reference', 'FusedChannelAttention',
           'fused_convlstm', 'convlstm_reference', 'convlstm_train_reference',
           'convlstm_backward_reference', 'convlstm_seq_reference',
           'convlstm_backward_tail', 'dispatch_info', 'FusedConvLSTM']
