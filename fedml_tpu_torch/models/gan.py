"""The DCGAN-style generator / discriminator pair of federated GAN
training (port of `fedml_tpu/models/gan.py`; reference:
model/model_hub.py:74-77, model/generative_adversarial_network/), sized
by `img_size` / `channels`, GroupNorm everywhere (BatchNorm statistics do
not federate).

Both take and return NHWC, as the flax modules do. Parameters keep
flax's names; `hub.params_from_flax` carries the flax pair across:
- the Generator reshapes its Dense output to NHWC (B, s, s, 2 width) and
  the Discriminator flattens NHWC before its Dense, so the activations
  are permuted, never the weights;
- a transposed conv's `kernel` is [out, in, kh, kw]: flax's (kh, kw, in,
  out) under `params_from_flax`'s HWIO -> OIHW transpose, the kernel of
  the equivalent convolution over the stride-dilated input. flax's
  `ConvTranspose(c, (4, 4), (2, 2))` ("SAME", transpose_kernel=False) is
  `F.conv_transpose2d(x, w, stride=2, padding=1)` with w that kernel
  flipped in both spatial axes and laid out [in, out, kh, kw], which
  `ConvTranspose` builds at use;
- the Discriminator's 4x4 stride-2 convs pad flax's "SAME" way, which is
  asymmetric on odd sizes (15 -> 8 pads (1, 2)); the Generator crops to
  `img_size` when it is not a multiple of 4.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hub import Conv, Dense, GroupNorm, _device


class ConvTranspose(nn.Module):
    """flax ConvTranspose, kernel (4, 4), strides (2, 2), "SAME": `kernel`
    [out, in, 4, 4] (module docstring), `bias` [out]; the output is twice
    the input's size."""

    def __init__(self, c_in: int, c_out: int, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((c_out, c_in, 4, 4),
                                               dtype=dtype, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty((c_out,), dtype=dtype,
                                             device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        w = self.kernel.to(dt).transpose(0, 1).flip((2, 3))
        return F.conv_transpose2d(x, w, self.bias.to(dt), stride=2,
                                  padding=1)


class Generator(nn.Module):
    """z [B, latent] -> image [B, img_size, img_size, channels] in
    (-1, 1)."""

    def __init__(self, img_size: int = 28, channels: int = 1,
                 latent: int = 64, width: int = 64, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        dev = _device(device)
        self.img_size, self.channels, self.latent = img_size, channels, latent
        self.width = width
        # ceil, so two stride-2 upsamples land at or above img_size (the
        # crop trims the excess)
        self.s = -(-img_size // 4)
        self.Dense_0 = Dense(latent, self.s * self.s * width * 2, dtype, dev)
        self.GroupNorm_0 = GroupNorm(8, width * 2, dtype, dev)
        self.ConvTranspose_0 = ConvTranspose(width * 2, width, dtype, dev)
        self.GroupNorm_1 = GroupNorm(8, width, dtype, dev)
        self.ConvTranspose_1 = ConvTranspose(width, channels, dtype, dev)

    def forward(self, z: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or self.Dense_0.kernel.dtype
        x = self.Dense_0(z.to(dt))
        x = x.reshape(-1, self.s, self.s, self.width * 2).permute(0, 3, 1, 2)
        x = torch.relu(self.GroupNorm_0(x))
        x = torch.relu(self.GroupNorm_1(self.ConvTranspose_0(x)))
        x = self.ConvTranspose_1(x)
        x = x[:, :, :self.img_size, :self.img_size]
        return torch.tanh(x).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """image [B, H, W, C] -> real / fake logit [B]. Its Dense's width
    follows from `input_shape` (H, W, C), which flax infers at init."""

    def __init__(self, input_shape=(28, 28, 1), width: int = 64, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        dev = _device(device)
        h, w, c = input_shape
        self.Conv_0 = Conv(c, width, 4, 2, True, dtype, dev)
        self.Conv_1 = Conv(width, width * 2, 4, 2, True, dtype, dev)
        self.GroupNorm_0 = GroupNorm(8, width * 2, dtype, dev)
        # two "SAME" stride-2 convs: ceil(ceil(n / 2) / 2)
        ho, wo = (-(-(-(-n // 2)) // 2) for n in (h, w))
        self.Dense_0 = Dense(ho * wo * width * 2, 1, dtype, dev)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or self.Dense_0.kernel.dtype
        x = F.leaky_relu(self.Conv_0(x.to(dt).permute(0, 3, 1, 2)), 0.2)
        x = F.leaky_relu(self.GroupNorm_0(self.Conv_1(x)), 0.2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x)[:, 0]


def gan_pair(num_classes=0, input_shape=None, *, dtype=torch.float32,
             device=None, width: int = 64, **kw) -> dict:
    """{"generator", "discriminator"} (the JAX hub's `_gan_pair`): `width`
    sizes both, `img_size` / `channels` / `latent` the generator, and the
    discriminator takes the generator's images. `num_classes` and
    `input_shape` are not read, as JAX's pair does not read them."""
    gen = Generator(width=width, dtype=dtype, device=device, **kw)
    disc = Discriminator((gen.img_size, gen.img_size, gen.channels),
                         width=width, dtype=dtype, device=device)
    return {"generator": gen, "discriminator": disc}
