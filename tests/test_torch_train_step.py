"""One GAN train step of the port against viai_tpu's make_train_step.

Both packages start from the same weights (tests/_torch_train_util.py)
and take a step under SGD (lr 0.1 for G and V, 0.05 for D; Adam would
amplify reduction-order noise in its first step, ~g/|g|) on the same
waveforms. JAX's own draws are fed to the port: the gap masks
(sample_batch_masks(step_mask_key(key))), G's dropout keep-masks
(bernoulli(fold_in(k_drop, i))) and the pool's (swap, idx). Compared:
every loss (rtol 1e-4) and every parameter's update, new − old, with
atol 1e-4 × the largest |update| of its net plus rtol 1e-3 (float32
sums in other orders through instance norms, tanh and D's backward;
measured on the CPU: ≤ 6.2e-6 × the net's largest update after one
step, 6.6e-5 for D after the pool case's two). Cases: both update
orders × {the default losses; every optional loss at once (l2, sc,
onset, fm with a 2-scale D, the phase head); av with frames_valid
(V's update included); the pool, over 2 steps so it swaps}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viai_tpu.io import flatten_state
from viai_tpu.testing import tone_batch
from viai_tpu.train import init_state as j_init_state
from viai_tpu.train import make_train_step as j_make_train_step
from viai_tpu.train.step import step_mask_key
from viai_tpu.signal.mask import sample_batch_masks as j_sample_masks
from viai_tpu_torch.train import init_state, make_train_step

from _torch_train_util import jax_cfg, make_D, make_G, make_V, port_cfg

LR_G, LR_D = 0.1, 0.05
UPD_ATOL, UPD_RTOL = 1e-4, 1e-3
LOSS_RTOL = 1e-4

CASES = {
    "default": dict(cfg={}, num_D=1, steps=1),
    "all_losses": dict(cfg=dict(lambda_l2=10.0, lambda_sc=1.0,
                                lambda_onset=5.0, lambda_fm=2.0,
                                phase_head=True, lambda_phase=1.0,
                                hole_weight=2.0), num_D=2, steps=1),
    "av_frames_valid": dict(cfg=dict(use_video=True), num_D=1, steps=1),
    "pool": dict(cfg=dict(pool_size=2), num_D=1, steps=2),
}


def _sgd(lr):
    return optax.with_extra_args_support(optax.sgd(lr))


def _jax_draws(key, G, B, cfg, x_shape):
    """The draws viai_tpu's train_step makes from `key`, as tensors."""
    k_mask, k_pool, k_drop = jax.random.split(key, 3)
    assert jnp.array_equal(jax.random.key_data(k_mask),
                           jax.random.key_data(step_mask_key(key)))
    jcfg = jax_cfg(cfg)
    tmask = np.array(j_sample_masks(k_mask, B, jcfg.image_frames, jcfg.mask))
    keep = 1.0 - G.cfg.dropout
    drop = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(k_drop, i), keep, (s[0], s[2], s[3], s[1])))
    ).permute(0, 3, 1, 2) for i, s in enumerate(G.dropout_shapes(x_shape))]
    pool = None
    if cfg.pool_size:
        k_swap, k_idx = jax.random.split(k_pool)
        pool = (torch.from_numpy(np.array(
                    jax.random.bernoulli(k_swap, 0.5, (B,)))),
                torch.from_numpy(np.array(jax.random.randint(
                    k_idx, (B,), 0, cfg.pool_size))).long())
    return torch.from_numpy(tmask), drop, pool


def _port_flat(mod):
    from viai_tpu_torch.io import flat_from_state

    return {k: v.numpy() for k, v in flat_from_state(mod).items()}


def _run(case, order):
    spec = CASES[case]
    cfg = port_cfg(update_order=order, **spec["cfg"])
    av = cfg.use_video
    out_nc = 3 if cfg.phase_head else 1
    JG, PG = make_G(dropout=0.5, fusion=16 if av else 0, out_nc=out_nc)
    JD, PD = make_D(num_D=spec["num_D"])
    JV, PV = make_V() if av else (None, None)
    jcfg = jax_cfg(cfg)
    g_tx, d_tx = _sgd(LR_G), _sgd(LR_D)
    (g_def, d_def, v_def), jstate = j_init_state(JG, JD, JV, g_tx, d_tx,
                                                 jcfg)
    jstep = j_make_train_step(g_def, d_def, v_def, g_tx, d_tx, jcfg)
    gv = list(PG.parameters()) + (list(PV.parameters()) if av else [])
    g_opt = torch.optim.SGD(gv, lr=LR_G)
    d_opt = torch.optim.SGD(PD.parameters(), lr=LR_D)
    state = init_state(PD, cfg)
    step = make_train_step(PG, PD, PV, g_opt, d_opt, cfg)

    B = 2
    wav = tone_batch(B, seed=3)
    wav += 0.01 * np.random.default_rng(4).standard_normal(wav.shape).astype(
        np.float32)
    frames = fv = None
    if av:
        frames = np.random.default_rng(5).uniform(
            0, 1, (B, 8, 16, 16, 3)).astype(np.float32)
        fv = np.array([1.0, 0.0], np.float32)
    before = {"G": flatten_state(jstate["g"]), "D": flatten_state(jstate["d"])}
    if av:
        before["V"] = flatten_state(jstate["v"])
    before = {n: {k: np.array(v) for k, v in f.items()}
              for n, f in before.items()}
    x_shape = (B, 2, cfg.n_bins, cfg.image_frames)
    for s in range(spec["steps"]):
        key = jax.random.key(11 + s)
        tmask, drop, pool = _jax_draws(key, PG, B, cfg, x_shape)
        jstate, jm = jstep(jstate, jnp.asarray(wav),
                           None if frames is None else jnp.asarray(frames),
                           key, None if fv is None else jnp.asarray(fv))
        pm = step(state, torch.from_numpy(wav),
                  None if frames is None else torch.from_numpy(frames),
                  None, None if fv is None else torch.from_numpy(fv),
                  tmask=tmask, dropout=drop, pool_draw=pool)
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert state["step"] == int(jstate["step"]) == spec["steps"]
    after = {"G": (jstate["g"], PG), "D": (jstate["d"], PD)}
    if av:
        after["V"] = (jstate["v"], PV)
    worst = {}
    for name, (jst, mod) in after.items():
        ja = flatten_state(jst)
        pa = _port_flat(mod)
        assert set(ja) == set(pa) == set(before[name])
        scale = max(np.abs(ja[k] - before[name][k]).max() for k in ja)
        assert scale > 0, f"{name} did not move"
        worst[name] = 0.0
        for k in ja:
            ju, pu = ja[k] - before[name][k], pa[k] - before[name][k]
            np.testing.assert_allclose(pu, ju, atol=UPD_ATOL * scale,
                                       rtol=UPD_RTOL, err_msg=f"{name}.{k}")
            worst[name] = max(worst[name],
                              float(np.abs(pu - ju).max()) / scale)
    if cfg.pool_size:
        np.testing.assert_allclose(
            state["pool"]["buf"].permute(0, 2, 3, 1).numpy(),
            np.asarray(jstate["pool"]["buf"]), atol=1e-5)
    return worst


@pytest.mark.parametrize("order", ["simultaneous", "sequential"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax_under_sgd(case, order):
    _run(case, order)


def test_remat_gives_the_same_step():
    """cfg.remat (G's forward under torch.utils.checkpoint, dropout masks
    drawn ahead) gives the no-remat step's updates: the recompute
    replays the same ops on the same inputs, so to rounding (1e-7
    relative), with dropout drawn from one generator seed in both."""
    res = []
    for remat in (False, True):
        cfg = port_cfg(remat=remat)
        _, PG = make_G(dropout=0.5)
        _, PD = make_D()
        g_opt = torch.optim.SGD(PG.parameters(), lr=LR_G)
        d_opt = torch.optim.SGD(PD.parameters(), lr=LR_D)
        step = make_train_step(PG, PD, None, g_opt, d_opt, cfg)
        m = step(init_state(PD, cfg), torch.from_numpy(tone_batch(2, seed=1)),
                 None, torch.Generator().manual_seed(0))
        res.append((m, {k: v.detach().clone()
                        for k, v in PG.state_dict().items()}))
    (m0, g0), (m1, g1) = res
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_d_gets_no_gradient_from_the_g_loss():
    """In the simultaneous order D's update comes from D's loss alone,
    though G's loss differentiates through D: it equals −lr × the
    gradient of D's loss on the detached fake of the same G, computed
    here by hand, and no parameter keeps a .grad after the step."""
    cfg = port_cfg()
    _, PG = make_G(dropout=0.5)
    _, PD = make_D()
    d0 = {k: v.clone() for k, v in PD.state_dict().items()}
    g_opt = torch.optim.SGD(PG.parameters(), lr=LR_G)
    d_opt = torch.optim.SGD(PD.parameters(), lr=LR_D)
    step = make_train_step(PG, PD, None, g_opt, d_opt, cfg)
    wav = torch.from_numpy(tone_batch(2, seed=2))
    gen = torch.Generator().manual_seed(1)
    tmask = torch.ones(2, 64)
    tmask[:, 20:30] = 0
    masks = PG.dropout_masks((2, 2, 64, 64), gen)
    step(init_state(PD, cfg), wav, None, tmask=tmask, dropout=masks)
    d_step = {k: v - d0[k] for k, v in PD.state_dict().items()}
    assert all(p.grad is None for p in list(PG.parameters())
               + list(PD.parameters()))
    # D's update by hand: D's loss on the detached fake of the same G.
    PD.load_state_dict(d0)
    from viai_tpu_torch.nn.losses import gan_loss
    from viai_tpu_torch.train.preprocess import g_input, preprocess_with_mask

    _, PG2 = make_G(dropout=0.5)
    batch = preprocess_with_mask(wav, tmask, cfg)
    x = g_input(batch)
    with torch.no_grad():
        fake = PG2(x, None, masks)
    real = batch["real_img"].permute(0, 3, 1, 2)
    loss = 0.5 * (gan_loss(PD(torch.cat([x, real], 1)), True)
                  + gan_loss(PD(torch.cat([x, fake], 1)), False))
    loss.backward()
    # new − old carries the rounding of new: one float32 ulp of a
    # parameter near 1 (the norm scales) is 1.2e-7.
    for k, p in PD.named_parameters():
        np.testing.assert_allclose(d_step[k].numpy(),
                                   (-LR_D * p.grad).numpy(), rtol=1e-4,
                                   atol=2e-7, err_msg=k)
