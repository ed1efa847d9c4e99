"""Shared builders of the training-path parity tests (tests/test_torch_train_*.py).

Tiny networks at viai_tpu.testing's sizes (n_fft 126, image_frames 64,
ngf 8, D ndf 8 with 2 layers, the tiny V) are built in the JAX package
from a seed, their parameters moved off their init by 0.02·N(0, 1)
from a numpy seed (so no bias is zero and no norm scale one), and
carried to the port through the flat `.pth` schema.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from viai_tpu.io import flatten_state
from viai_tpu.io.checkpoint import unflatten_into
from viai_tpu.nn import DiscriminatorConfig as JDConfig
from viai_tpu.nn import GeneratorConfig as JGConfig
from viai_tpu.nn import MultiScaleDiscriminator as JMultiD
from viai_tpu.nn import PatchDiscriminator as JPatchD
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import VideoFeatureNet as JVideo
from viai_tpu.nn import VideoNetConfig as JVConfig
from viai_tpu.testing import TINY_CFG
from viai_tpu_torch.io import state_from_flat
from viai_tpu_torch.nn import (DiscriminatorConfig, GeneratorConfig,
                               MultiScaleDiscriminator, PatchDiscriminator,
                               UNetGenerator, VideoFeatureNet, VideoNetConfig)
from viai_tpu_torch.signal import MaskConfig, STFTConfig
from viai_tpu_torch.train import TrainConfig

G_TINY = dict(ngf=8, strides=((2, 2), (2, 2), (2, 1)), mults=(1, 2, 4))
V_TINY = dict(base=4, mults=(1, 2), strides=((1, 2, 2), (2, 2, 2)),
              out_features=16, out_time=16)
D_TINY = dict(ndf=8, n_layers=2)


def port_cfg(**kw) -> TrainConfig:
    """The port's TrainConfig equal to viai_tpu.testing.TINY_CFG (+ kw)."""
    j = TINY_CFG
    return TrainConfig(
        stft=STFTConfig(n_fft=j.stft.n_fft, hop_length=j.stft.hop_length),
        mask=MaskConfig(j.mask.min_gap_frames, j.mask.max_gap_frames),
        image_frames=j.image_frames, lambda_l1=j.lambda_l1,
        n_bins=j.stft.n_fft // 2 + 1, **kw)


def jax_cfg(cfg: TrainConfig):
    """The JAX TrainConfig of a port TrainConfig built by port_cfg."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("stft", "mask")}
    return dataclasses.replace(TINY_CFG, **fields)


def perturb(module, seed):
    """Move every parameter of a JAX module by 0.02·N(0, 1); → its flat
    state."""
    _, state = nnx.split(module)
    rng = np.random.default_rng(seed)
    flat = {k: v + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_state(state).items()}
    nnx.update(module, jax.tree.map(jnp.asarray, unflatten_into(state, flat)))
    return flat


def to_port(jmod, pmod, seed):
    """Perturb the JAX module and load its weights into the port's."""
    pmod.load_state_dict(state_from_flat(perturb(jmod, seed), pmod))
    return pmod


def make_G(seed=0, dropout=0.0, fusion=0, out_nc=1, in_nc=2):
    jcfg = JGConfig(in_channels=in_nc, out_channels=out_nc, dropout=dropout,
                    **G_TINY)
    pcfg = GeneratorConfig(in_channels=in_nc, out_channels=out_nc,
                           dropout=dropout, **G_TINY)
    JG = JUNet(jcfg, nnx.Rngs(seed), fusion_channels=fusion)
    return JG, to_port(JG, UNetGenerator(pcfg, fusion_channels=fusion),
                       100 + seed)


def make_D(seed=1, num_D=1, in_nc=3, norm="instance"):
    jcfg = JDConfig(in_channels=in_nc, norm=norm, **D_TINY)
    pcfg = DiscriminatorConfig(in_channels=in_nc, norm=norm, **D_TINY)
    if num_D > 1:
        JD = JMultiD(jcfg, num_D, nnx.Rngs(seed))
        PD = MultiScaleDiscriminator(pcfg, num_D)
    else:
        JD = JPatchD(jcfg, nnx.Rngs(seed))
        PD = PatchDiscriminator(pcfg)
    return JD, to_port(JD, PD, 100 + seed)


def make_V(seed=2):
    JV = JVideo(JVConfig(**V_TINY), nnx.Rngs(seed))
    return JV, to_port(JV, VideoFeatureNet(VideoNetConfig(**V_TINY)),
                       100 + seed)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
