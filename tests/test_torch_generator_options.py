"""G's options in the port against viai_tpu's, through the weight bridge.

A JAX G is built from a seed with each option of
`viai_tpu/nn/factory.py::define_G`; every one of its parameters is then
moved off its init by 0.02·N(0, 1) from a numpy seed (the attention
blocks' zero-initialised projections would otherwise make them the
identity, and unit norm scales and zero biases would hide a swapped
key), the weights cross to the port through the flat `.pth` schema, and
the same numpy input goes through both.

Bounds: atol 5e-4, rtol 1e-3 in float32, as tests/test_torch_generator.py
(float32 conv summation order, through the norms). In bf16 both sides
round every activation to 8 significant bits at places that differ
(XLA's and oneDNN's bf16 convolutions accumulate and round in their own
order; flax adds each conv bias after rounding, torch before), so the
two outputs are two bf16 roundings of one function: atol 3e-2 on the
tanh output in [-1, 1] (three bf16 ulps at 1; see the test for the
measured error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from viai_tpu.io import flatten_state
from viai_tpu.io.checkpoint import unflatten_into
from viai_tpu.nn import GeneratorConfig as JConfig
from viai_tpu.nn import UNetGenerator as JUNet
from viai_tpu.nn import define_G as j_define_G
from viai_tpu.nn.generator import AttentionBlock as JAttention
from viai_tpu.nn.generator import ChannelLayerNorm as JLayerNorm
from viai_tpu.nn.generator import _sincos_pos_embed as j_pos_embed
from viai_tpu_torch.io import generator_state_from_flat, state_from_flat
from viai_tpu_torch.nn import (AttentionBlock, ChannelLayerNorm,
                               GeneratorConfig, GroupNorm, UNetGenerator,
                               define_G, sincos_pos_embed)
from viai_tpu_torch.nn.generator import init_parameters

# Four levels at ngf 8: a (4, 16, 64) bottleneck, 8 heads of 8 channels.
TINY = dict(ngf=8, strides=((2, 2), (2, 2), (2, 1), (2, 1)),
            mults=(1, 2, 4, 8))
F32_TOL = dict(atol=5e-4, rtol=1e-3)
BF16_ATOL = 3e-2
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _perturb(module, seed):
    """Move every parameter of a flax module by 0.02·N(0, 1), in place;
    returns the flat state the port's bridge reads."""
    g_def, state = nnx.split(module)
    rng = np.random.default_rng(seed)
    flat = {k: v + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_state(state).items()}
    new = jax.tree.map(jnp.asarray, unflatten_into(state, flat))
    nnx.update(module, new)
    return flat


def _pair(fusion=0, seed=0, **opts):
    dtype = opts.pop("dtype", "float32")
    JG = JUNet(JConfig(dtype=JDTYPES[dtype], **TINY, **opts), nnx.Rngs(seed),
               fusion_channels=fusion)
    flat = _perturb(JG, seed + 100)
    pcfg = GeneratorConfig(dtype=dtype, **TINY, **opts)
    PG = UNetGenerator(pcfg, fusion_channels=fusion).eval()
    PG.load_state_dict(generator_state_from_flat(flat, pcfg, fusion))
    return JG, PG, flat, pcfg


def _run_both(JG, PG, x, feats=None):
    ours = np.asarray(JG(x, feats))
    with torch.no_grad():
        theirs = PG(torch.from_numpy(x).permute(0, 3, 1, 2),
                    None if feats is None else torch.from_numpy(feats))
    return ours, theirs.permute(0, 2, 3, 1).numpy()


OPTIONS = {
    "gated": dict(gated=True),
    "dilation_1_2_4": dict(bottleneck_dilation=(1, 2, 4)),
    "attention": dict(bottleneck_attn=1),
    "fusion_16": dict(fusion=16),
    "groupnorm_instance": dict(norm="groupnorm_instance"),
    "dropout_no_key": dict(dropout=0.5),
    "gated_resize": dict(gated=True, upsample="resize"),
    "av_recipe": dict(fusion=16, gated=True, bottleneck_dilation=(1, 2, 4),
                      bottleneck_attn=2, dropout=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_generator_option_matches_jax(name):
    opts = dict(OPTIONS[name])
    fusion = opts.pop("fusion", 0)
    JG, PG, _, _ = _pair(fusion, **opts)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 2)).astype(np.float32)
    feats = (rng.standard_normal((2, 16, fusion)).astype(np.float32)
             if fusion else None)
    a, b = _run_both(JG, PG, x, feats)
    assert a.shape == b.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(b, a, **F32_TOL)


def test_generator_bfloat16_matches_jax():
    """bf16 compute, float32 params and tanh, with the options whose
    norms and attention cast in and out of float32. Measured max |Δ|
    on this input: 5.7e-3 (bound 3e-2, see the module docstring)."""
    JG, PG, _, _ = _pair(fusion=16, dtype="bfloat16", gated=True,
                         bottleneck_dilation=(1, 2), bottleneck_attn=1,
                         norm="groupnorm_instance")
    assert all(p.dtype == torch.float32 for p in PG.parameters())
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 64, 2)).astype(np.float32)
    feats = rng.standard_normal((2, 16, 16)).astype(np.float32)
    a, b = _run_both(JG, PG, x, feats)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=BF16_ATOL, rtol=0)


def test_full_width_av_generator_matches_jax():
    """The README's --model av recipe at full width (ngf 64, six
    levels, fusion 256, gated, dilation 1,2,4, dropout 0.5), batch 1 at
    the serving shape; bound 1e-3 as the full-width G of
    tests/test_torch_generator.py."""
    kw = dict(fusion_channels=256, gated=True, bottleneck_dilation=(1, 2, 4),
              dropout=0.5)
    JG = j_define_G(seed=5, **kw)
    PG = define_G(device="cpu", **kw)
    PG.load_state_dict(generator_state_from_flat(
        flatten_state(nnx.split(JG)[1]), PG.cfg, 256))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 256, 256, 2)).astype(np.float32)
    feats = rng.standard_normal((1, 16, 256)).astype(np.float32)
    a, b = _run_both(JG, PG, x, feats)
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-3)


def test_fusion_generator_needs_features():
    G = define_G(ngf=8, fusion_channels=16, device="cpu")
    with pytest.raises(ValueError, match="fusion_features"):
        G(torch.zeros(1, 2, 64, 64))


@pytest.mark.parametrize("shape", [(4, 16, 64), (2, 3, 12), (1, 1, 8)])
def test_sincos_pos_embed_matches_jax(shape):
    a = np.asarray(j_pos_embed(*shape))
    b = sincos_pos_embed(*shape).numpy()
    assert a.shape == b.shape == (shape[0] * shape[1], shape[2])
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_channel_layer_norm_matches_jax():
    """float32 moments, eps 1e-6, over the last axis. Bound 1e-4: at a
    mean of 3 the E[x²] − E[x]² variance cancels about a decimal digit
    of float32 (measured max |Δ| 1.6e-5)."""
    jn = JLayerNorm(24, jnp.float32)
    flat = _perturb(jn, 7)
    pn = ChannelLayerNorm(24)
    pn.load_state_dict(state_from_flat(flat, pn))
    x = 3.0 + np.random.default_rng(4).standard_normal(
        (2, 10, 24)).astype(np.float32)
    np.testing.assert_allclose(pn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jn(x)), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(dtype):
    """One block on a (2, 4, 16, 64) grid (tokens flattened frequency-
    major, 8 heads, tanh GELU). float32: bound 5e-4 as G's; bf16: two
    bf16 ulps of the output's largest values (|y| ≤ 4, an ulp of
    1.6e-2), 3.2e-2 (measured 1.6e-2)."""
    jb = JAttention(64, 8, JDTYPES[dtype], nnx.Rngs(3))
    flat = _perturb(jb, 8)
    pb = AttentionBlock(64, 8)
    pb.load_state_dict(state_from_flat(flat, pb))
    x = np.random.default_rng(5).standard_normal((2, 4, 16, 64)).astype(
        np.float32)
    a = np.asarray(jb(jnp.asarray(x, JDTYPES[dtype])).astype(jnp.float32))
    with torch.no_grad():
        b = pb(torch.from_numpy(x).permute(0, 3, 1, 2).to(
            getattr(torch, dtype))).permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(b, a, **F32_TOL)
    else:
        np.testing.assert_allclose(b, a, atol=3.2e-2, rtol=0)
    # Initialised as G initialises it, the block is the identity (its
    # output projections are zero).
    fresh = AttentionBlock(64, 8)
    init_parameters(fresh, "normal", 0.02)
    with torch.no_grad():
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        assert torch.equal(fresh(y), y)


@pytest.mark.parametrize("groups,dtype", [(16, "float32"), (8, "float32"),
                                          (8, "bfloat16")])
def test_group_norm_matches_jax(groups, dtype):
    """flax nnx.GroupNorm on an NDHWC and an NHWC tensor, against the
    port's on NCDHW/NCHW: float32 bound 1e-5; bf16 (scale and bias
    rounded to bf16 as flax promotes them, output rounded): one bf16
    ulp of the output, 2e-2 on values up to ~3."""
    jn = nnx.GroupNorm(num_features=16, num_groups=groups,
                       dtype=JDTYPES[dtype], param_dtype=jnp.float32,
                       rngs=nnx.Rngs(0))
    flat = _perturb(jn, 9)
    pn = GroupNorm(16, groups)
    pn.load_state_dict(state_from_flat(flat, pn))
    rng = np.random.default_rng(6)
    for shape in ((2, 3, 5, 4, 16), (2, 6, 7, 16)):
        x = (1.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
        a = np.asarray(jn(jnp.asarray(x, JDTYPES[dtype])).astype(
            jnp.float32))
        perm = (0, x.ndim - 1, *range(1, x.ndim - 1))
        back = (0, *range(2, x.ndim), 1)
        with torch.no_grad():
            b = pn(torch.from_numpy(x).permute(*perm).to(
                getattr(torch, dtype))).permute(*back).float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(b, a, atol=1e-5)
        else:
            np.testing.assert_allclose(b, a, atol=2e-2)


def test_bridge_is_strict_for_option_keys():
    _, _, flat, pcfg = _pair(fusion=16, gated=True, bottleneck_dilation=(1,),
                             bottleneck_attn=1)
    missing = dict(flat)
    del missing["attn_blocks.0.qkv.kernel"]
    with pytest.raises(KeyError, match="attn_blocks.0.qkv.kernel"):
        generator_state_from_flat(missing, pcfg, 16)
    # The fusion conv's keys are unexpected for a G built without it.
    with pytest.raises(KeyError, match="fuse"):
        generator_state_from_flat(flat, pcfg, 0)
    # A non-gated kernel where the gated conv is 2·cout wide.
    bad = dict(flat)
    bad["downs.1.conv.kernel"] = bad["downs.1.conv.kernel"][..., :16]
    with pytest.raises(ValueError, match="downs.1.conv.kernel"):
        generator_state_from_flat(bad, pcfg, 16)
    extra = dict(flat, **{"bott_blocks.1.norm.scale": np.ones(64, np.float32)})
    with pytest.raises(KeyError, match="bott_blocks.1.norm.scale"):
        generator_state_from_flat(extra, pcfg, 16)
