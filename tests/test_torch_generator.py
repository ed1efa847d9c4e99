"""The port's U-Net G against viai_tpu's, through the weight bridge.

A JAX G is built from a seed; its weights cross to the port through
viai_tpu_torch.io (the flat `.pth` schema that viai_tpu's
save_networks writes), and the same numpy input goes through both.
Bound atol 5e-4 at ngf 8, as tests/test_torch_parity.py:251 (float32
conv summation order, through instance norms); 1e-3 for the
full-width G, whose convs sum over up to 16·1024 terms.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state, save_networks
from viai_tpu.nn import GeneratorConfig as JConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import define_G as j_define_G
from viai_tpu_torch.io import (generator_state_from_flat, load_generator_pth,
                               load_networks)
from viai_tpu_torch.nn import GeneratorConfig, UNetGenerator, define_G
from viai_tpu_torch.nn.initializers import kernel_init_for

# Two stride-(2, 1) levels: the asymmetric (1, 2) conv padding and the
# (2, 1) transposed-conv padding on the time axis.
TINY = dict(ngf=8, strides=((2, 2), (2, 2), (2, 1), (2, 1)),
            mults=(1, 2, 4, 8))


def _pair(upsample, norm, seed=0):
    jcfg = JConfig(upsample=upsample, norm=norm, **TINY)
    pcfg = GeneratorConfig(upsample=upsample, norm=norm, **TINY)
    JG = JUNet(jcfg, nnx.Rngs(seed))
    flat = flatten_state(nnx.split(JG)[1])
    PG = UNetGenerator(pcfg).eval()
    PG.load_state_dict(generator_state_from_flat(flat, pcfg))
    return JG, PG, flat, pcfg


def _run_both(JG, PG, x):
    ours = np.asarray(JG(x))
    with torch.no_grad():
        theirs = PG(torch.from_numpy(x).permute(0, 3, 1, 2))
    return ours, theirs.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("upsample,norm", [
    ("deconv", "instance"), ("resize", "instance"),
    ("deconv", "batch"), ("deconv", "none"),
])
def test_generator_matches_jax(upsample, norm):
    JG, PG, _, _ = _pair(upsample, norm)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 2)).astype(
        np.float32)
    a, b = _run_both(JG, PG, x)
    assert a.shape == b.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(b, a, atol=5e-4, rtol=1e-3)


def test_full_width_define_G_matches_jax():
    """One batch-1 forward of the define_G() defaults (ngf 64, six
    levels, deconv) at the serving shape 256×256."""
    JG = j_define_G(seed=3)
    PG = define_G(device="cpu")
    PG.load_state_dict(generator_state_from_flat(
        flatten_state(nnx.split(JG)[1]), PG.cfg))
    x = np.random.default_rng(2).uniform(-1, 1, (1, 256, 256, 2)).astype(
        np.float32)
    a, b = _run_both(JG, PG, x)
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-3)


def test_pth_file_bridge(tmp_path):
    JG, _, flat, pcfg = _pair("deconv", "instance", seed=4)
    save_networks({"G": nnx.split(JG)[1]}, 7, str(tmp_path))
    sd = load_generator_pth(str(tmp_path / "7_net_G.pth"), pcfg)
    PG = load_networks({"G": UNetGenerator(pcfg).eval()}, "latest",
                       str(tmp_path))["G"]
    for k, v in PG.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 2)).astype(
        np.float32)
    a, b = _run_both(JG, PG, x)
    np.testing.assert_allclose(b, a, atol=5e-4, rtol=1e-3)


def test_bridge_is_strict():
    _, _, flat, pcfg = _pair("deconv", "instance")
    missing = dict(flat)
    del missing["ups.1.norm.scale"]
    with pytest.raises(KeyError, match="ups.1.norm.scale"):
        generator_state_from_flat(missing, pcfg)
    extra = dict(flat, **{"bott_blocks.0.conv.kernel": np.zeros(3)})
    with pytest.raises(KeyError, match="bott_blocks"):
        generator_state_from_flat(extra, pcfg)
    bad = dict(flat, **{"head.bias": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="head.bias"):
        generator_state_from_flat(bad, pcfg)


@pytest.mark.parametrize("init_type,std", [
    ("normal", lambda fi, fo: 0.02),
    ("xavier", lambda fi, fo: 0.02 * np.sqrt(2.0 / (fi + fo))),
    ("kaiming", lambda fi, fo: np.sqrt(2.0 / fi)),
    ("lecun", lambda fi, fo: np.sqrt(1.0 / fi)),
])
def test_kernel_init_std(init_type, std):
    """Draws over the flax (kh, kw, cin, cout) fans; std within 3%
    (sampling error of 2^16 draws is ~0.3%)."""
    shape = (4, 4, 64, 64)
    w = kernel_init_for(init_type, 0.02)(shape, torch.Generator().manual_seed(0))
    fi, fo = 16 * 64, 16 * 64
    assert abs(float(w.std()) / std(fi, fo) - 1.0) < 0.03


def test_orthogonal_init_has_orthogonal_columns():
    w = kernel_init_for("orthogonal", 0.5)((3, 3, 8, 16),
                                           torch.Generator().manual_seed(0))
    m = w.reshape(72, 16)
    np.testing.assert_allclose((m.T @ m).numpy(), 0.25 * np.eye(16),
                               atol=1e-5)


def test_define_G_seed_is_deterministic():
    a = define_G(ngf=8, seed=1, device="cpu").state_dict()
    b = define_G(ngf=8, seed=1, device="cpu").state_dict()
    c = define_G(ngf=8, seed=2, device="cpu").state_dict()
    k = "downs.1.conv.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert abs(float(a[k].std()) - 0.02) < 0.002
