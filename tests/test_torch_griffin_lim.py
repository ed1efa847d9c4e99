"""The port's plain Griffin-Lim against both JAX paths.

viai_tpu_torch.signal.griffin_lim (the plain version of the Hopper
kernel) is held against viai_tpu's jnp `griffin_lim` and against
`griffin_lim_pallas(..., interpret=True)`, the Pallas kernel run in
interpret mode as tests/test_pallas_gl.py runs it. GL is an iterated
nonlinear map, so parity is taken at n_iter ≤ 4 with the bound of
tests/test_pallas_gl.py, atol = rtol = 1e-3: float32 summation order,
amplified where the window envelope is small at the clip edges.
"""

import numpy as np
import pytest
import torch

import viai_tpu.signal as J
from viai_tpu.signal.pallas_gl import griffin_lim_pallas
import viai_tpu_torch.signal as P
from viai_tpu_torch.signal.gl_cuda import griffin_lim_cuda

# (n_fft, hop, clip samples): the small test config, and the product
# config at 10 hops (as tests/test_pallas_gl.py:157-172).
CONFIGS = {"small": (126, 32, 2048), "product": (510, 128, 1280)}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


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


@pytest.mark.parametrize("n_iter", [0, 1, 4])
@pytest.mark.parametrize("mode", ["zero", "observed_extrapolate"])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_plain_gl_matches_jnp_and_pallas(cfg_name, mode, n_iter):
    jc, pc, n, mag, obs = _case(cfg_name, seed=n_iter)
    kw = {}
    if mode == "observed_extrapolate":
        kw = dict(observed=obs, phase_init="extrapolate")
    ref = np.asarray(J.griffin_lim(mag, jc, n_iter=n_iter, length=n, **kw))
    pal = np.asarray(griffin_lim_pallas(mag, jc, n_iter=n_iter, length=n,
                                        interpret=True, **kw))
    pkw = dict(kw)
    if "observed" in pkw:
        pkw["observed"] = tuple(_t(a) for a in obs)
    out = P.griffin_lim(_t(mag), pc, n_iter=n_iter, length=n, **pkw).numpy()
    assert out.shape == ref.shape == (mag.shape[0], n)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out, pal, atol=1e-3, rtol=1e-3)


def test_observed_with_zero_init_matches_jnp():
    jc, pc, n, mag, obs = _case("small", seed=5)
    ref = J.griffin_lim(mag, jc, n_iter=4, length=n, observed=obs)
    out = P.griffin_lim(_t(mag), pc, n_iter=4, length=n,
                        observed=tuple(_t(a) for a in obs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


def test_random_init_is_explicit_init_of_the_same_draws():
    """torch.Generator draws differ from jax.random's, so the random
    init is pinned as: generator init == explicit init of the same
    draws, and that explicit init matches JAX's explicit init."""
    jc, pc, n, mag, _ = _case("small", seed=6)
    a = P.griffin_lim(_t(mag), pc, n_iter=2, length=n,
                      generator=torch.Generator().manual_seed(3))
    ang = torch.rand(mag.shape, generator=torch.Generator().manual_seed(3),
                     dtype=torch.float32) * (2.0 * np.pi)
    init = (torch.cos(ang), torch.sin(ang))
    b = P.griffin_lim(_t(mag), pc, n_iter=2, length=n, init=init)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = J.griffin_lim(mag, jc, n_iter=2, length=n,
                        init=tuple(x.numpy() for x in init))
    np.testing.assert_allclose(b.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-3)


def test_wrapper_on_cpu_runs_the_plain_version():
    jc, pc, n, mag, obs = _case("product", seed=8)
    tobs = tuple(_t(a) for a in obs)
    calls, launches = P.griffin_lim.calls, griffin_lim_cuda.launches
    out = griffin_lim_cuda(_t(mag), pc, n_iter=2, length=n, observed=tobs,
                           phase_init="extrapolate")
    assert P.griffin_lim.calls == calls + 1
    assert griffin_lim_cuda.launches == launches
    ref = P.griffin_lim(_t(mag), pc, n_iter=2, length=n, observed=tobs,
                        phase_init="extrapolate")
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_extrapolate_requires_observed():
    _, pc, n, mag, _ = _case("small")
    with pytest.raises(ValueError):
        P.griffin_lim(_t(mag), pc, n_iter=1, length=n,
                      phase_init="extrapolate")
