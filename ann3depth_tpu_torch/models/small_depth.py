"""Small 3-conv downsample depth net.

Counterpart of `ann3depth_tpu/models/small_depth.py`: three stride-2
convs with bias (5x5, 3x3, 3x3) and relus between them, so 320x240 RGB
gives log-depth at 1/8 resolution (30x40). NHWC in, NHWC out, NCHW inside
as in models/encdec.py. Both presets that name it compute in f32; with
bf16 every conv runs in bf16 and the output is cast to f32.

Where flax and torch differ: the widths are `max(8, int(c * width_mult))`
(not encdec's multiple of 8), and flax "SAME" pads the 5x5 stride-2 conv
(1, 2) on even sizes, which `Conv` (`same_padding`) reproduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.models.encdec import Conv, init_flax_


class SmallDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32 -> NHWC [B, H/8, W/8, 1]
    log-depth f32."""

    S2D_INPUT_FACTOR = 0
    OUTPUT_STRIDE = 8

    def __init__(self, width_mult=1.0, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.widths = [max(8, int(c * width_mult)) for c in (32, 64)]
        w1, w2 = self.widths
        self.conv1 = Conv(3, w1, 5, 2, bias=True)
        self.conv2 = Conv(w1, w2, 3, 2, bias=True)
        self.conv3 = Conv(w2, 1, 3, 2, bias=True)

    def init_weights(self, generator=None, input_hw=None):
        """flax init: lecun_normal kernels, zero biases."""
        return init_flax_(self, generator)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        low = self.compute_dtype != torch.float32
        # No weight-cast cache: a CUDA graph cannot capture it.
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low, cache_enabled=False):
            x = x.to(self.compute_dtype)
            x = F.relu(self.conv1(x))
            x = F.relu(self.conv2(x))
            x = self.conv3(x)
        return x.float().permute(0, 2, 3, 1)

    @staticmethod
    def output_hw(input_hw):
        h, w = input_hw
        return (h // SmallDepthNet.OUTPUT_STRIDE,
                w // SmallDepthNet.OUTPUT_STRIDE)

    @staticmethod
    def width_mult_of(state_dict):
        """A width_mult that rebuilds a state_dict's widths: conv2 has
        int(64 wm) channels, and half of that rounds down to conv1's."""
        return state_dict["conv2.weight"].shape[0] / 64
