"""The host-side layout of the Hopper Griffin-Lim kernel, and why it
multiplies in 3xTF32, on the CPU.

The kernel (`viai_tpu_torch/csrc/griffin_lim.cu`) cannot run here, so
what surrounds it is checked instead:
  * `tf32_split`: hi + lo reconstructs the float32 bases to 2⁻²¹
    relative, and both halves carry TF32's 10-bit mantissa;
  * `kernel_bases`: K-major, cos/sin and icos/isin interleaved, each
    entry where the kernel's indexing reads it, zero in the pad;
    `stage_tiles`: each entry at the offset the kernel's shared-memory
    stage and wgmma descriptors read;
  * `prepare_buffers`: the first synthesis operand and the observed
    bins interleaved as the kernel's epilogue writes them;
  * a torch emulation of the kernel's dataflow on those buffers (dense
    A, overlap-add into a reflect-padded waveform, analysis rows read as
    windows of it, the interleaved epilogue) against JAX's `griffin_lim`
    and the port's plain version, with float32 and with 3xTF32 products;
  * 3xTF32 products in the plain `griffin_lim` stay within the card
    tests' bound (atol = rtol = 1e-3 at n_iter 4), one TF32 pass does
    worse: the reason the kernel pays for three passes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import viai_tpu.signal as J
import viai_tpu_torch.signal as P
from viai_tpu_torch.signal import gl_cuda as G
from viai_tpu_torch.signal.griffin_lim import prepare_gl
from viai_tpu_torch.signal.stft import (_dft_bases, _idft_bases,
                                        _padded_window, overlap_add)

CONFIGS = {"small": (126, 32, 2048), "product": (510, 128, 1280)}


def _cfg(name):
    n_fft, hop, _ = CONFIGS[name]
    return P.STFTConfig(n_fft, hop)


def _case(name, seed=0, batch=2):
    n_fft, hop, n = CONFIGS[name]
    jc = J.STFTConfig(n_fft, hop)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f = rng.uniform(200, 1500, (batch, 2))
    x = (0.4 * np.sin(2 * np.pi * f[:, :, None] * t).sum(1)
         + 0.02 * rng.standard_normal((batch, n))).astype(np.float32)
    re, im = (np.asarray(a) for a in J.stft(x, jc))
    mag = np.sqrt(re * re + im * im + 1e-12).astype(np.float32)
    F = re.shape[1]
    fmask = np.ones((batch, F, 1), np.float32)
    fmask[:, F // 3 : F // 3 + max(F // 5, 2)] = 0.0
    return jc, P.STFTConfig(n_fft, hop), n, mag, (fmask, re, im)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      -(one + ulp / 2), one + ulp * 0.75, 3.0, 0.0])
    want = torch.tensor([one + ulp, one, -(one + ulp), one + ulp, 3.0, 0.0])
    assert torch.equal(G.tf32_round(x), want)


@pytest.mark.parametrize("which", ["syn", "ana"])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_split_bases_reconstruct_float32(cfg_name, which):
    cfg = _cfg(cfg_name)
    full = dict(zip(("syn", "ana"), G.kernel_bases(cfg)))[which]
    c = G._constants(cfg, 11, torch.device("cpu"))
    hi, lo = G.tf32_split(full)
    assert torch.equal(getattr(c, f"{which}_hi"), G.stage_tiles(hi))
    assert torch.equal(getattr(c, f"{which}_lo"), G.stage_tiles(lo))
    mask = (1 << G.TF32_DROP) - 1
    for half in (hi, lo):
        assert half.dtype == torch.float32
        assert not bool((half.view(torch.int32) & mask).any())
    err = (hi.double() + lo.double() - full.double()).abs()
    assert bool((err <= 2.0 ** -21 * full.double().abs()).all())
    # One half alone is TF32's 2⁻¹¹, not float32's accuracy.
    assert float((hi - full).abs().max()) > 2.0 ** -16 * float(full.abs().max())


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_bases_are_k_major_and_interleaved(cfg_name):
    cfg = _cfg(cfg_name)
    n, nb = cfg.n_fft, cfg.n_bins
    syn, ana = (b.numpy() for b in G.kernel_bases(cfg))
    w = G.padded_width(n)
    assert syn.shape == ana.shape == (w, w)
    win = _padded_window(cfg)
    cos_b, sin_b = _dft_bases(n)
    icos, isin = _idft_bases(n)
    icosw = (icos * win[None, :]).astype(np.float32)
    isinw = (isin * win[None, :]).astype(np.float32)
    cosw = (win[:, None] * cos_b).astype(np.float32)
    sinw = (win[:, None] * sin_b).astype(np.float32)
    rng = np.random.default_rng(0)
    for _ in range(200):                 # spot entries, as the kernel reads
        k, j = int(rng.integers(nb)), int(rng.integers(n))
        assert syn[j, 2 * k] == icosw[k, j]          # row = sample n
        assert syn[j, 2 * k + 1] == isinw[k, j]      # K = (re, im) of bin k
        assert ana[2 * k, j] == cosw[j, k]           # row = (cos, sin) of k
        assert ana[2 * k + 1, j] == sinw[j, k]       # K = sample j
    # Whole blocks too: the strided views are the plain bases.
    np.testing.assert_array_equal(syn[:n, 0:2 * nb:2], icosw.T)
    np.testing.assert_array_equal(syn[:n, 1:2 * nb:2], isinw.T)
    np.testing.assert_array_equal(ana[0:2 * nb:2, :n], cosw.T)
    np.testing.assert_array_equal(ana[1:2 * nb:2, :n], sinw.T)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_pad_rows_and_columns_are_zero(cfg_name):
    cfg = _cfg(cfg_name)
    n, nb = cfg.n_fft, cfg.n_bins
    w = G.padded_width(n)
    assert w % G.ROW_ALIGN == 0 and w >= 2 * nb > n
    assert G.padded_width(510) == 512 and G.padded_width(126) == 128
    for syn, ana in (G.kernel_bases(cfg),
                     tuple(G.tf32_split(b)[1] for b in G.kernel_bases(cfg))):
        assert not bool(syn[n:].any()) and not bool(syn[:, 2 * nb:].any())
        assert not bool(ana[2 * nb:].any()) and not bool(ana[:, n:].any())
        # Stage tiles hold the same numbers, pad included.
        assert torch.equal(G.stage_tiles(syn).sort().values,
                           syn.reshape(-1).sort().values)


@pytest.mark.parametrize("rows, width, tile", [
    (8 * 251, 512, 64),             # bucket 8: 128 blocks of 128 x 64
    (32 * 251, 512, 128),           # bucket 32: 252 blocks of 128 x 128
    (128 * 251, 512, 128),
    (3 * 11, 128, 64),              # tiny: no tile fills the card
])
def test_tile_policy_fills_the_card(rows, width, tile):
    assert G.pick_tile(rows, width, 132) == tile
    assert tile in G.TILES
    blocks = -(-rows // G.BLOCK_ROWS) * (width // tile)
    assert tile == min(G.TILES) or 10 * blocks >= 9 * 132


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_stage_tiles_put_entries_where_the_kernel_reads(cfg_name):
    w = G.padded_width(_cfg(cfg_name).n_fft)
    b = torch.arange(w * w, dtype=torch.float32).reshape(w, w)
    t = G.stage_tiles(b)
    rng = np.random.default_rng(1)
    for n, k in rng.integers(0, w, (300, 2)):
        s, c, e = k // G.STAGE_K, (k % G.STAGE_K) // 4, k % 4
        # The kernel: stage s at s·STAGE_K·W floats, the block's rows at
        # n0·STAGE_K, unit u = (n / 8)·8·CHUNKS + c·8 + n % 8 of 4 floats.
        u = (n // 8) * 8 * (G.STAGE_K // 4) + c * 8 + n % 8
        assert t[s * G.STAGE_K * w + 4 * u + e] == b[n, k]


def test_buffers_interleave_the_first_operand():
    _, pc, n, mag, obs = _case("small", seed=3)
    tobs = tuple(_t(a) for a in obs)
    buf = G.prepare_buffers(_t(mag), pc, tobs, "extrapolate")
    magp, (ore, oim), re0, im0 = prepare_gl(_t(mag), tobs, "extrapolate",
                                              None)
    B, F, nb = mag.shape
    w = G.padded_width(pc.n_fft)
    assert buf.a.shape == buf.obs.shape == buf.prev.shape == (B * F, w)
    assert buf.wav.shape == (B, pc.hop_length * (F - 1) + w)
    assert buf.out.shape == (B, n)
    a = buf.a.reshape(B, F, w)
    torch.testing.assert_close(a[..., 0:2 * nb:2], magp * re0 + ore,
                               rtol=0, atol=0)
    torch.testing.assert_close(a[..., 1:2 * nb:2], magp * im0 + oim,
                               rtol=0, atol=0)
    assert not bool(buf.prev.any()) and not bool(a[..., 2 * nb:].any())
    assert buf.mag.shape == (B * F, w // 2)
    torch.testing.assert_close(buf.mag[:, :nb], magp.reshape(B * F, nb))
    assert not bool(buf.mag[:, nb:].any())


def _float32(x, parts):
    return x @ (parts[0] + parts[1]).T


def _three_tf32(x, parts):
    hi, lo = parts
    xh, xl = G.tf32_split(x)
    return xl @ hi.T + xh @ lo.T + xh @ hi.T


def _emulate(buf, n_iter, product, momentum=0.99):
    """The kernel's dataflow in torch: gl_synth, gl_ola and gl_analyze
    per iteration on the kernel's buffers and split bases."""
    cfg = buf.cfg
    B, L = buf.wav.shape
    M, w = buf.a.shape
    F, nb = M // B, cfg.n_bins
    mag = buf.mag[:, :nb]
    n, hop, pad = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    total = hop * (F - 1) + n
    c = G._constants(cfg, F, buf.a.device)
    syn, ana = (G.tf32_split(b) for b in G.kernel_bases(cfg))
    beta = momentum / (1.0 + momentum)
    p = np.arange(total)
    q = np.where(p < pad, 2 * pad - p,
                 np.where(p >= total - pad, 2 * (total - pad - 1) - p, p))

    def ola(a):
        frames = product(a, syn).reshape(B, F, w)
        assert not bool(frames[..., n:].any())
        return overlap_add(frames[..., :n], hop) * c.inv_env

    a, prev = buf.a.clone(), buf.prev.clone()
    for _ in range(n_iter):
        wav = TF.pad(ola(a)[:, q], (0, L - total))
        rows = wav.unfold(-1, w, hop)                  # (B, F, w) windows
        assert rows.shape[1] == F
        spec = product(rows.reshape(M, w), ana)
        nre, nim = spec[:, 0:2 * nb:2], spec[:, 1:2 * nb:2]
        are = nre - beta * prev[:, 0:2 * nb:2]
        aim = nim - beta * prev[:, 1:2 * nb:2]
        inv = torch.rsqrt(are * are + aim * aim + 1e-16)
        new = G.interleave(mag * (are * inv), mag * (aim * inv), w)
        if buf.obs is not None:
            new = new + buf.obs
        # As the kernel: bins with mag' = 0 keep A (= obs) and prev.
        live = G.interleave(mag != 0, mag != 0, w)
        a = torch.where(live, new, a)
        prev = torch.where(live, G.interleave(nre, nim, w), prev)
    return ola(a)[:, pad : pad + hop * (F - 1)]


@pytest.mark.parametrize("product", ["float32", "3xtf32"])
@pytest.mark.parametrize("n_iter", [0, 1, 4])
@pytest.mark.parametrize("mode", ["zero", "observed_extrapolate"])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_kernel_dataflow_matches_jnp_and_plain(cfg_name, mode, n_iter,
                                               product):
    jc, pc, n, mag, obs = _case(cfg_name, seed=n_iter + 10)
    kw, pkw = {}, {}
    if mode == "observed_extrapolate":
        kw = dict(observed=obs, phase_init="extrapolate")
        pkw = dict(observed=tuple(_t(a) for a in obs),
                   phase_init="extrapolate")
    buf = G.prepare_buffers(_t(mag), pc, **pkw)
    fn = {"float32": _float32, "3xtf32": _three_tf32}[product]
    out = _emulate(buf, n_iter, fn).numpy()
    ref = np.asarray(J.griffin_lim(mag, jc, n_iter=n_iter, length=n, **kw))
    plain = P.griffin_lim(_t(mag), pc, n_iter=n_iter, length=n, **pkw)
    assert out.shape == ref.shape == (mag.shape[0], n)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out, plain.numpy(), atol=1e-3, rtol=1e-3)


def test_three_tf32_passes_keep_the_bound_one_does_not(monkeypatch):
    """Plain GL×4 on the small config with every product emulated."""
    _, pc, n, mag, obs = _case("small", seed=4)
    kw = dict(observed=tuple(_t(a) for a in obs), phase_init="extrapolate")
    ref = P.griffin_lim(_t(mag), pc, n_iter=4, length=n, **kw)
    matmul = torch.matmul

    def three(x, y):
        (xh, xl), (yh, yl) = G.tf32_split(x), G.tf32_split(y)
        return matmul(xl, yh) + matmul(xh, yl) + matmul(xh, yh)

    def one(x, y):
        return matmul(G.tf32_round(x), G.tf32_round(y))

    errs = {}
    for name, fn in (("3xtf32", three), ("1xtf32", one)):
        monkeypatch.setattr(torch, "matmul", fn)
        out = P.griffin_lim(_t(mag), pc, n_iter=4, length=n, **kw)
        monkeypatch.setattr(torch, "matmul", matmul)
        errs[name] = float((out - ref).abs().max())
        if name == "3xtf32":
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-3,
                                       rtol=1e-3)
    assert errs["1xtf32"] > 10 * errs["3xtf32"], errs
