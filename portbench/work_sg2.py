"""The work of StyleGAN2 config F's generator: operations and bytes a
layer, and the necessary operations of a refinement step.

Counted as ``work.py`` counts (2 operations a multiply-add; each input read
once, each output written once):

* a dense layer of I inputs and O outputs: 2 I O an image (the mapping,
  and each layer's style affine from w);
* a modulated k x k convolution of Ci to Co channels at an r x r output:
  2 r r k k Ci Co, the style scaling and the demodulation left to the
  elementwise work; the demodulation's sums are a Ci x Co product an image
  (2 Ci Co);
* an up-sampling convolution: the stride-2 transposed convolution touches
  each input pixel with all 9 taps, 2 r r 9 Ci Co for an r x r input;
* the FIR blurs and the skip's up-sampling: stencils of 16 taps a pixel
  and channel at activation size, bound by memory; counted in bytes only;
* the backward to the input costs what the forward costs (the style's and
  the demodulation's gradients are reductions at activation size).

One forward of config F at 1024 x 1024 is 74.27 G multiply-adds: 74.07 G
in the 3x3 convolutions, 0.20 G in ToRGB, the rest in the dense layers.
"""
from __future__ import annotations

from .reference_sg2 import channels, resolutions
from .work import Layer, conv, dense, forward_flops


def upconv(name: str, r: int, ci: int, co: int) -> Layer:
    """A stride-2 transposed 3x3 convolution of an r x r input (9 taps an
    input pixel), output 2r x 2r after the blur."""
    return Layer(name, 2 * r * r * 9 * ci * co, r * r * ci, 9 * ci * co,
                 4 * r * r * co, co)


def fir(name: str, r_in: int, r_out: int, c: int) -> Layer:
    """A FIR pass of ``c`` channels, r_in x r_in in, r_out x r_out out."""
    return Layer(name, 0, r_in * r_in * c, 16, r_out * r_out * c, c)


def modulated(name: str, r: int, ci: int, co: int, wd: int, k: int = 3,
              up: bool = False, demodulate: bool = True) -> list:
    """A modulated layer's style affine, demodulation sums, convolution and
    (``up``) blur; ``r`` is the output's size."""
    layers = [dense(f"{name}.affine", wd, ci)]
    if demodulate:
        layers.append(dense(f"{name}.demod", ci, co))
    if up:
        layers += [upconv(name, r // 2, ci, co),
                   fir(f"{name}.blur", r + 1, r, co)]
    else:
        layers.append(conv(name, r, r, ci, co, k=k))
    return layers


def g_sg2_layers(cfg) -> list:
    """Every layer of one forward, mapping first, then block by block."""
    zd, wd, img = cfg["noise_dim"], cfg["w_dim"], cfg["image"][0]
    layers = [dense(f"mapping.l{i}", zd if i == 1 else wd, wd)
              for i in range(1, cfg["mapping_layers"] + 1)]
    prev = None
    for r in resolutions(cfg):
        c = channels(cfg, r)
        if prev is None:
            layers += modulated("b4.conv", r, c, c, wd)
        else:
            layers += modulated(f"b{r}.conv0", r, prev, c, wd, up=True)
            layers += modulated(f"b{r}.conv1", r, c, c, wd)
            layers.append(fir(f"b{r}.skip", r // 2, r, img))
        layers += modulated(f"b{r}.torgb", r, c, img, wd, k=1,
                            demodulate=False)
        prev = c
    return layers


def forward_macs(cfg) -> int:
    """Multiply-adds of one image's forward."""
    return forward_flops(g_sg2_layers(cfg)) // 2


def refine_flops(cfg, chunk: int, steps: int) -> int:
    """A refinement step's necessary operations: at each adam step, the
    forward and the backward to the input of every row of the chunk."""
    return 2 * forward_flops(g_sg2_layers(cfg)) * chunk * steps
