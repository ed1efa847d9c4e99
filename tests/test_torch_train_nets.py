"""The port's discriminators, losses, decoder dropout, mask sampler and
mel functions against viai_tpu's, on identical inputs and weights.

Weights cross through the flat `.pth` schema (tests/_torch_train_util.py).
Bounds: D logits and features atol 5e-4, rtol 1e-3 (float32 conv
summation order through instance norms, as tests/test_torch_generator.py);
losses rtol 1e-5 (one float32 reduction each); G with injected dropout
masks as G without (5e-4); the mel filterbank exactly (the same numpy
code), its application 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viai_tpu.nn import losses as jl
from viai_tpu.signal import mask as jmask
from viai_tpu.signal import mel as jmel
from viai_tpu_torch.nn import avg_pool_same, define_D
from viai_tpu_torch.nn import losses as pl
from viai_tpu_torch.signal import MaskConfig, mel as pmel
from viai_tpu_torch.signal import sample_batch_masks, sample_time_mask

from _torch_train_util import make_D, make_G, nchw, nhwc

TOL = dict(atol=5e-4, rtol=1e-3)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("num_D,norm", [(1, "instance"), (2, "instance"),
                                        (1, "batch"), (3, "none")])
def test_discriminator_matches_jax(num_D, norm):
    JD, PD = make_D(num_D=num_D, norm=norm)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    j_logits, j_feats = JD(jnp.asarray(x), return_features=True)
    with torch.no_grad():
        p_logits, p_feats = PD(nchw(x), return_features=True)
        p_plain = PD(nchw(x))
    if num_D == 1:
        j_logits, p_logits, p_plain = [j_logits], [p_logits], [p_plain]
    assert len(p_logits) == len(j_logits) == num_D
    assert len(p_feats) == len(j_feats) == 3 * num_D
    for a, b, c in zip(j_logits, p_logits, p_plain):
        np.testing.assert_allclose(nhwc(b), np.asarray(a), **TOL)
        np.testing.assert_array_equal(b.numpy(), c.numpy())
    for a, b in zip(j_feats, p_feats):
        np.testing.assert_allclose(nhwc(b), np.asarray(a), **TOL)


@pytest.mark.parametrize("size", [(64, 64), (33, 20), (8, 5)])
def test_avg_pool_same_matches_flax(size):
    from flax import nnx

    x = np.random.default_rng(0).standard_normal((2, *size, 3)).astype(
        np.float32)
    a = nnx.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    b = nhwc(avg_pool_same(nchw(x)))
    np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)


def test_define_D_seeds_and_shapes():
    a = define_D(3, 8, 2, seed=1, device="cpu").state_dict()
    b = define_D(3, 8, 2, seed=1, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert "norms.0.weight" not in a and "norms.1.weight" in a
    ms = define_D(3, 8, 2, num_D=2, device="cpu")
    assert "nets.1.head.weight" in ms.state_dict()
    assert abs(float(a["convs.1.weight"].std()) - 0.02) < 0.003


def _logits(seed, shape=(2, 1, 8, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge"])
@pytest.mark.parametrize("scales", [1, 2])
def test_gan_losses_match_jax(mode, scales):
    ls = [_logits(s, (2, 8 // (s + 1), 8, 1)) for s in range(scales)]
    j_in = [jnp.asarray(l) for l in ls] if scales > 1 else jnp.asarray(ls[0])
    p_in = ([torch.from_numpy(l) for l in ls] if scales > 1
            else torch.from_numpy(ls[0]))
    for real in (True, False):
        np.testing.assert_allclose(float(pl.gan_loss(p_in, real, mode)),
                                   float(jl.gan_loss(j_in, real, mode)),
                                   **LOSS_TOL)
    np.testing.assert_allclose(float(pl.generator_gan_loss(p_in, mode)),
                               float(jl.generator_gan_loss(j_in, mode)),
                               **LOSS_TOL)
    with pytest.raises(ValueError, match="unknown gan mode"):
        pl.gan_loss(p_in, True, "wgan")


def _images(seed, shape=(2, 16, 12, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-1, 1, shape).astype(np.float32)
    tgt = rng.uniform(-1, 1, shape).astype(np.float32)
    keep = np.ones(shape, np.float32)
    keep[:, :, 4:9] = 0.0
    return pred, tgt, keep


@pytest.mark.parametrize("name", ["masked_l1_loss", "masked_l2_loss",
                                  "onset_l1_loss"])
@pytest.mark.parametrize("hole_weight", [1.0, 3.0])
def test_masked_losses_match_jax(name, hole_weight):
    pred, tgt, keep = _images(1)
    a = getattr(jl, name)(jnp.asarray(pred), jnp.asarray(tgt),
                          jnp.asarray(keep), hole_weight=hole_weight)
    b = getattr(pl, name)(torch.from_numpy(pred), torch.from_numpy(tgt),
                          torch.from_numpy(keep), hole_weight=hole_weight)
    np.testing.assert_allclose(float(b), float(a), **LOSS_TOL)


def test_magnitude_and_phase_losses_match_jax():
    rng = np.random.default_rng(2)
    shape = (2, 16, 12)
    pm, tm = (rng.uniform(0, 5, shape).astype(np.float32) for _ in range(2))
    keep = np.ones(shape, np.float32)
    keep[..., 3:8] = 0.0
    a = jl.hole_spectral_convergence_loss(*map(jnp.asarray, (pm, tm, keep)))
    b = pl.hole_spectral_convergence_loss(*map(torch.from_numpy,
                                               (pm, tm, keep)))
    np.testing.assert_allclose(float(b), float(a), **LOSS_TOL)
    pc, ps = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 2 * np.pi, shape)
    tr, ti = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    args = (pc, ps, tr, ti, keep, tm)
    a = jl.phase_cosine_loss(*map(jnp.asarray, args))
    b = pl.phase_cosine_loss(*map(torch.from_numpy, args))
    np.testing.assert_allclose(float(b), float(a), **LOSS_TOL)
    np.testing.assert_allclose(
        float(pl.l1_loss(torch.from_numpy(pm), torch.from_numpy(tm))),
        float(jl.l1_loss(jnp.asarray(pm), jnp.asarray(tm))), **LOSS_TOL)


def test_feature_matching_matches_jax_and_detaches_real():
    rng = np.random.default_rng(4)
    ff = [rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
          for _ in range(3)]
    fr = [rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
          for _ in range(3)]
    a = jl.feature_matching_loss([jnp.asarray(f) for f in ff],
                                 [jnp.asarray(f) for f in fr])
    pff = [torch.from_numpy(f).requires_grad_() for f in ff]
    pfr = [torch.from_numpy(f).requires_grad_() for f in fr]
    b = pl.feature_matching_loss(pff, pfr)
    np.testing.assert_allclose(float(b.detach()), float(a), **LOSS_TOL)
    b.backward()
    assert all(f.grad is None for f in pfr)
    assert all(f.grad is not None for f in pff)


def test_dropout_with_injected_jax_masks_matches_jax():
    """G with JAX's keep-masks (drawn as viai_tpu draws them from a
    dropout key) injected equals JAX's G run with that key."""
    JG, PG = make_G(dropout=0.5)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 2)).astype(
        np.float32)
    key = jax.random.key(9)
    shapes = PG.dropout_shapes((2, 2, 64, 64))
    assert len(shapes) == 3
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(key, i), 0.5, (s[0], s[2], s[3], s[1])))
    ).permute(0, 3, 1, 2) for i, s in enumerate(shapes)]
    a = np.asarray(JG(jnp.asarray(x), dropout_key=key))
    with torch.no_grad():
        b = nhwc(PG(nchw(x), None, masks))
        det = nhwc(PG(nchw(x)))
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(det, np.asarray(JG(jnp.asarray(x))), **TOL)
    assert np.abs(b - det).max() > 1e-3          # the masks acted


def test_dropout_generator_draws_and_determinism():
    _, PG = make_G(dropout=0.5)
    x = torch.zeros(2, 2, 64, 64)
    m = PG.dropout_masks(x.shape, torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in m] == PG.dropout_shapes(x.shape)
    frac = float(torch.cat([t.flatten() for t in m]).float().mean())
    assert abs(frac - 0.5) < 0.02
    with torch.no_grad():
        y1 = PG(x, None, torch.Generator().manual_seed(0))
        y2 = PG(x, None, m)
        PG.train()
        y3, y4 = PG(x), PG(x)
    assert torch.equal(y1, y2) and torch.equal(y3, y4)
    with pytest.raises(ValueError, match="dropout masks"):
        PG(x, None, m[:1])


@pytest.mark.parametrize("cfg", [
    MaskConfig(25, 50), MaskConfig(8, 16, num_gaps=2),
    MaskConfig(75, 150), MaskConfig(50, 50, fixed_start=103)])
def test_mask_sampler_invariants(cfg):
    n = 256
    m = sample_batch_masks(torch.Generator().manual_seed(0), 2000, n, cfg)
    assert m.shape == (2000, n) and m.dtype == torch.float32
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    holes = (m == 0).sum(1)
    assert int(holes.min()) >= cfg.min_gap_frames
    assert int(holes.max()) <= cfg.num_gaps * cfg.max_gap_frames
    if cfg.num_gaps == 1:
        # One contiguous gap per clip, inside the clip.
        edges = (m[:, 1:] != m[:, :-1]).sum(1)
        assert int(edges.max()) <= 2
        assert int(holes.max()) <= cfg.max_gap_frames
    if cfg.fixed_start is not None:
        assert bool((m[:, cfg.fixed_start:cfg.fixed_start + 50] == 0).all())
        assert bool((m[:, :cfg.fixed_start] == 1).all())
    one = sample_time_mask(torch.Generator().manual_seed(1), n, cfg)
    assert one.shape == (n,)


def _ks(a, b):
    grid = np.union1d(a, b)
    ca = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.abs(ca - cb).max())


def test_mask_sampler_distribution_matches_jax():
    """Gap lengths and starts over 4000 draws each, against JAX's
    sampler: two-sample KS statistic below 0.045 (the 0.1% critical
    value at n = m = 4000 is 1.95·sqrt(2/4000) = 0.044)."""
    cfg = MaskConfig(25, 50)
    n, N = 256, 4000
    jm = np.asarray(jmask.sample_batch_masks(
        jax.random.key(0), N, n, jmask.MaskConfig(25, 50)))
    pm = sample_batch_masks(torch.Generator().manual_seed(0), N, n,
                            cfg).numpy()
    for m in (jm, pm):
        assert (m[:, -1] + m[:, 0] > 0).all()
    jl_, pl_ = (jm == 0).sum(1), (pm == 0).sum(1)
    js, ps = (jm == 0).argmax(1), (pm == 0).argmax(1)
    assert _ks(jl_, pl_) < 0.045, _ks(jl_, pl_)
    assert _ks(js, ps) < 0.045, _ks(js, ps)
    assert set(np.unique(pl_)) == set(range(25, 51))


def test_mel_functions_match_jax():
    f = np.array([0.0, 440.0, 999.0, 1000.0, 4000.0, 8000.0])
    for htk in (False, True):
        np.testing.assert_array_equal(pmel.hz_to_mel(f, htk),
                                      jmel.hz_to_mel(f, htk))
        m = jmel.hz_to_mel(f, htk)
        np.testing.assert_array_equal(pmel.mel_to_hz(m, htk),
                                      jmel.mel_to_hz(m, htk))
        np.testing.assert_array_equal(
            pmel.mel_filterbank(16000, 510, 80, htk=htk),
            jmel.mel_filterbank(16000, 510, 80, htk=htk))
    fb = pmel.mel_filterbank(16000, 510, 80)
    mag = np.random.default_rng(0).uniform(0, 3, (2, 10, 256)).astype(
        np.float32)
    np.testing.assert_allclose(
        pmel.apply_mel(torch.from_numpy(mag), fb).numpy(),
        np.asarray(jmel.apply_mel(jnp.asarray(mag), jnp.asarray(fb))),
        rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(1)
    re, im = (rng.standard_normal((2, 8, 16)).astype(np.float32) * 5
              for _ in range(2))
    a = jmel.complex_compress(jnp.asarray(re), jnp.asarray(im))
    b = pmel.complex_compress(torch.from_numpy(re), torch.from_numpy(im))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-7)
    a2 = jmel.complex_decompress(*a)
    b2 = pmel.complex_decompress(*b)
    for x, y, r in zip(a2, b2, (re, im)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(y.numpy(), r, rtol=1e-4, atol=1e-5)


def test_preprocess_draws_masks_as_the_sampler_does():
    from viai_tpu.testing import tone_batch
    from viai_tpu_torch.train import preprocess, preprocess_with_mask

    from _torch_train_util import port_cfg

    cfg = port_cfg()
    wav = torch.from_numpy(tone_batch(3, seed=2))
    a = preprocess(wav, torch.Generator().manual_seed(3), cfg)
    tmask = sample_batch_masks(torch.Generator().manual_seed(3), 3,
                               cfg.image_frames, cfg.mask)
    b = preprocess_with_mask(wav, tmask, cfg)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(a["mask_img"].min()) == 0.0
