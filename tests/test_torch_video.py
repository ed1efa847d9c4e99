"""The port's video feature net against viai_tpu's, through the bridge.

A JAX VideoFeatureNet is built from a seed (viai_tpu.testing's tiny
config, and the define_V() defaults at full width), its parameters
moved off their init by 0.02·N(0, 1) from a numpy seed, and its
weights carried to the port through the flat `.pth` schema; the same
numpy frames go through both. Bound atol 5e-4, rtol 1e-3 in float32,
as the torch twin of tests/test_torch_parity.py (float32 summation
order of the 3D convs, through the group norms).

The time resize is held against `jax.image.resize(..., "linear")` for
upsampling, the identity and antialiased downsampling (1e-6: the same
weights, computed in float64 here and float32 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state, save_networks
from viai_tpu.io.checkpoint import unflatten_into
from viai_tpu.nn import VideoFeatureNet as JVideo
from viai_tpu.nn import VideoNetConfig as JVideoConfig
from viai_tpu.nn import define_V as j_define_V
from viai_tpu.testing import tiny_models
from viai_tpu_torch.io import (load_networks, load_video_pth,
                               video_state_from_flat)
from viai_tpu_torch.nn import (GeneratorConfig, UNetGenerator,
                               VideoFeatureNet, VideoNetConfig, define_V,
                               resize_time)

TOL = dict(atol=5e-4, rtol=1e-3)


def _perturbed_flat(module, seed):
    _, state = nnx.split(module)
    rng = np.random.default_rng(seed)
    flat = {k: v + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_state(state).items()}
    nnx.update(module, jax.tree.map(jnp.asarray, unflatten_into(state, flat)))
    return flat


def _port_cfg(jcfg, dtype="float32"):
    return VideoNetConfig(
        in_channels=jcfg.in_channels, base=jcfg.base, strides=jcfg.strides,
        mults=jcfg.mults, out_features=jcfg.out_features,
        out_time=jcfg.out_time, dtype=dtype)


def _run_both(JV, PV, frames):
    a = np.asarray(JV(frames))
    with torch.no_grad():
        b = PV(torch.from_numpy(frames)).numpy()
    return a, b


@pytest.mark.parametrize("n_frames", [8, 32])
def test_tiny_video_net_matches_jax(n_frames):
    """tiny_models(use_video=True)'s V: T 8 → 4 resized up to 16, and
    T 32 → 16 (no resize)."""
    JV = tiny_models(use_video=True)[2]
    flat = _perturbed_flat(JV, 1)
    pcfg = _port_cfg(JV.cfg)
    PV = VideoFeatureNet(pcfg).eval()
    PV.load_state_dict(video_state_from_flat(flat, pcfg))
    frames = np.random.default_rng(2).standard_normal(
        (2, n_frames, 16, 16, 3)).astype(np.float32)
    a, b = _run_both(JV, PV, frames)
    assert a.shape == b.shape == (2, 16, 16)
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, a, **TOL)


def test_video_net_downsampling_resize_matches_jax():
    """out_time below the convs' time axis: the antialiased resize."""
    jcfg = JVideoConfig(base=4, mults=(1, 2), strides=((1, 2, 2), (1, 2, 2)),
                        out_features=8, out_time=3)
    JV = JVideo(jcfg, nnx.Rngs(3))
    flat = _perturbed_flat(JV, 4)
    pcfg = _port_cfg(jcfg)
    PV = VideoFeatureNet(pcfg).eval()
    PV.load_state_dict(video_state_from_flat(flat, pcfg))
    frames = np.random.default_rng(5).standard_normal(
        (2, 10, 8, 8, 3)).astype(np.float32)
    a, b = _run_both(JV, PV, frames)
    assert a.shape == b.shape == (2, 3, 8)
    np.testing.assert_allclose(b, a, **TOL)


def test_full_width_define_V_matches_jax():
    """define_V() defaults (channels 32/64/128/256, time 16 → 4,
    resized up to 16) on one clip of (16, 64, 64, 3) frames."""
    JV = j_define_V(seed=2)
    PV = define_V(device="cpu")
    PV.load_state_dict(video_state_from_flat(
        flatten_state(nnx.split(JV)[1]), PV.cfg))
    frames = np.random.default_rng(6).uniform(
        0, 1, (1, 16, 64, 64, 3)).astype(np.float32)
    a, b = _run_both(JV, PV, frames)
    assert a.shape == b.shape == (1, 16, 256)
    np.testing.assert_allclose(b, a, **TOL)


def test_video_net_bfloat16_matches_jax():
    """bf16 convs and resize, float32 params, moments and output. Both
    sides round every activation to bf16 at places that differ (the
    conv bias before or after rounding, accumulation order), so the
    bound is bf16's: atol 2e-3 on features up to 0.054 here (eight bf16
    ulps at that scale); measured 4.9e-4."""
    jcfg = JVideoConfig(base=4, mults=(1, 2), strides=((1, 2, 2), (2, 2, 2)),
                        out_features=16, out_time=16, dtype=jnp.bfloat16)
    JV = JVideo(jcfg, nnx.Rngs(7))
    flat = _perturbed_flat(JV, 8)
    pcfg = _port_cfg(jcfg, dtype="bfloat16")
    PV = VideoFeatureNet(pcfg).eval()
    PV.load_state_dict(video_state_from_flat(flat, pcfg))
    frames = np.random.default_rng(9).standard_normal(
        (2, 8, 16, 16, 3)).astype(np.float32)
    a, b = _run_both(JV, PV, frames)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n_in", [2, 4, 16, 32])
def test_resize_time_matches_jax_image_resize(n_in):
    """T′ → 16: upsampling (2, 4), the identity (16), antialiased
    downsampling (32), against jax.image.resize(..., "linear")."""
    h = np.random.default_rng(n_in).standard_normal((3, 5, n_in)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(h), (3, 5, 16), "linear"))
    out = resize_time(torch.from_numpy(h), 16).numpy()
    assert out.shape == ref.shape == (3, 5, 16)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    if n_in < 16:
        # Upsampling is plain linear interpolation with half-pixel centres.
        ti = torch.nn.functional.interpolate(torch.from_numpy(h), size=16,
                                             mode="linear")
        np.testing.assert_allclose(out, ti.numpy(), atol=1e-6)


def test_define_V_seed_and_device():
    a = define_V(base=4, seed=1, device="cpu").state_dict()
    b = define_V(base=4, seed=1, device="cpu").state_dict()
    c = define_V(base=4, seed=2, device="cpu").state_dict()
    k = "convs.1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a[k].shape == (8, 4, 3, 3, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            define_V()


def test_video_bridge_is_strict():
    JV = tiny_models(use_video=True)[2]
    flat = flatten_state(nnx.split(JV)[1])
    pcfg = _port_cfg(JV.cfg)
    missing = dict(flat)
    del missing["norms.1.scale"]
    with pytest.raises(KeyError, match="norms.1.scale"):
        video_state_from_flat(missing, pcfg)
    extra = dict(flat, **{"convs.2.bias": np.zeros(8, np.float32)})
    with pytest.raises(KeyError, match="convs.2.bias"):
        video_state_from_flat(extra, pcfg)
    bad = dict(flat, **{"proj.kernel": np.zeros((16, 8), np.float32)})
    with pytest.raises(ValueError, match="proj.kernel"):
        video_state_from_flat(bad, pcfg)


def test_pth_file_bridge_loads_G_and_V(tmp_path):
    """save_networks({"G", "V"}) → load_video_pth and load_networks."""
    JG, _, JV = tiny_models(use_video=True, seed=3)
    save_networks({"G": nnx.split(JG)[1], "V": nnx.split(JV)[1]}, 4,
                  str(tmp_path))
    pcfg = _port_cfg(JV.cfg)
    sd = load_video_pth(str(tmp_path / "4_net_V.pth"), pcfg)
    gc = JG.cfg
    PG = UNetGenerator(GeneratorConfig(ngf=gc.ngf, strides=gc.strides,
                                       mults=gc.mults),
                       fusion_channels=16).eval()
    nets = load_networks({"G": PG, "V": VideoFeatureNet(pcfg).eval()},
                         "latest", str(tmp_path))
    for k, v in nets["V"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    frames = np.random.default_rng(10).standard_normal(
        (1, 8, 16, 16, 3)).astype(np.float32)
    a, b = _run_both(JV, nets["V"], frames)
    np.testing.assert_allclose(b, a, **TOL)
    x = np.random.default_rng(11).standard_normal((1, 64, 64, 2)).astype(
        np.float32)
    with torch.no_grad():
        g = nets["G"](torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(b)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(g, np.asarray(JG(x, a)), **TOL)
