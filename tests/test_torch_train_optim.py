"""The port's ImagePool, lr schedules, Adam and plateau scale against
viai_tpu's and optax's.

Bounds: the pool exactly (the same images moved); schedules rtol 1e-6
(float32 in JAX, float64 here); Adam rtol 1e-5 of each parameter over
20 updates (float32 arithmetic in both, in optax's order; the bias
corrections' powers may round differently by an ulp); the plateau
scale exactly (the same comparisons on the same float32 averages).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from viai_tpu.train import pool as jpool
from viai_tpu.train import schedules as jsched
from viai_tpu_torch.train import (Adam, ReduceOnPlateau, adam, draw_pool,
                                  init_pool, make_schedule, optimizer_step,
                                  plateau_kwargs, plateau_scale, query_pool)


def _jax_draws(key, batch, size):
    k_swap, k_idx = jax.random.split(key)
    swap = jax.random.bernoulli(k_swap, 0.5, (batch,))
    idx = jax.random.randint(k_idx, (batch,), 0, size)
    return torch.from_numpy(np.array(swap)), torch.from_numpy(
        np.array(idx)).long()


@pytest.mark.parametrize("size,batch", [(4, 3), (2, 4), (5, 5)])
def test_pool_matches_jax_with_its_draws(size, batch):
    """Fill, overflow and swap over 6 queries, JAX's draws fed to the
    port's pure update; NHWC items there, NCHW here."""
    item = (3, 4, 2)                                  # (H, W, C)
    jp = jpool.init_pool(size, item)
    pp = init_pool(size, (item[2], item[0], item[1]))
    rng = np.random.default_rng(0)
    for q in range(6):
        fakes = rng.standard_normal((batch, *item)).astype(np.float32)
        key = jax.random.key(q)
        jp, jout = jpool.query_pool(jp, jnp.asarray(fakes), key)
        pp, pout = query_pool(pp, torch.from_numpy(fakes).permute(0, 3, 1, 2),
                              *_jax_draws(key, batch, size))
        np.testing.assert_array_equal(pout.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jout))
        np.testing.assert_array_equal(pp["buf"].permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jp["buf"]))
        assert pp["n"] == int(jp["n"])


def test_pool_draws_and_duplicates():
    swap, idx = draw_pool(torch.Generator().manual_seed(0), 4000, 7)
    assert abs(float(swap.float().mean()) - 0.5) < 0.03
    assert set(idx.tolist()) == set(range(7))
    pool = {"buf": torch.zeros(2, 1, 1, 1), "n": 2}
    fakes = torch.arange(1.0, 4.0).view(3, 1, 1, 1)
    pool, out = query_pool(pool, fakes, torch.tensor([True, True, False]),
                           torch.tensor([1, 1, 0]))
    # Both swapping items read the old slot 1; the later one's fake wins.
    assert out.flatten().tolist() == [0.0, 0.0, 3.0]
    assert pool["buf"].flatten().tolist() == [0.0, 2.0]


@pytest.mark.parametrize("policy", ["lambda", "step", "cosine", "constant",
                                    "plateau"])
def test_schedules_match_jax(policy):
    kw = dict(niter=3, niter_decay=4, lr_decay_iters=2, steps_per_epoch=5)
    js = jsched.make_schedule(policy, 2e-4, **kw)
    ps = make_schedule(policy, 2e-4, **kw)
    for step in range(0, 45):
        np.testing.assert_allclose(ps(step), float(js(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="unknown lr policy"):
        make_schedule("linear", 1e-3)


def _grad_sequence(n, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) * (1 + k % 3)
             for s in shapes] for k in range(n)]


@pytest.mark.parametrize("policy", ["lambda", "cosine"])
def test_adam_matches_optax(policy):
    shapes = [(5, 3), (7,)]
    kw = dict(niter=1, niter_decay=2, lr_decay_iters=1, steps_per_epoch=6)
    init = [np.random.default_rng(9).standard_normal(s).astype(np.float32)
            for s in shapes]
    tx = jsched.adam(jsched.make_schedule(policy, 1e-2, **kw))
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = adam(params, make_schedule(policy, 1e-2, **kw))
    for grads in _grad_sequence(20, shapes):
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                jparams, value=jnp.float32(0.0))
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        optimizer_step(opt, torch.tensor(0.0))
        for p, j in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       rtol=1e-5, atol=1e-7)
    assert opt.count == 20 and plateau_scale(opt) is None


def test_plateau_matches_optax():
    """Scripted losses: improving, flat (patience runs out twice), an
    improvement, flat again; accumulation over 3 values, cooldown 1."""
    kw = dict(factor=0.2, patience=2, rtol=0.01, atol=0.0, cooldown=1,
              accumulation_size=3)
    losses = ([5.0, 4.0, 3.0] * 1 + [3.0] * 18 + [1.0, 1.0, 1.0]
              + [1.0] * 15)
    jt = optax.contrib.reduce_on_plateau(**kw)
    js = jt.init(jnp.zeros(2))
    pt = ReduceOnPlateau(**kw)
    scales = []
    for v in losses:
        upd, js = jt.update(jnp.ones(2), js, value=jnp.float32(v))
        s = pt.update(torch.tensor(v))
        assert float(s) == float(upd[0]) == float(js.scale)
        assert int(pt.state["plateau_count"]) == int(js.plateau_count)
        assert int(pt.state["cooldown_count"]) == int(js.cooldown_count)
        assert float(pt.state["best_value"]) == float(js.best_value)
        scales.append(float(s))
    assert len(set(scales)) >= 3          # the scale was cut at least twice


def test_adam_plateau_chain_matches_optax():
    shapes = [(4,)]
    kw = plateau_kwargs(2) | dict(patience=1)
    tx = jsched.adam(jsched.make_schedule("plateau", 1e-2), plateau=kw)
    init = [np.ones(4, np.float32)]
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    params = [torch.nn.Parameter(torch.ones(4))]
    opt = adam(params, make_schedule("plateau", 1e-2), plateau=kw)
    values = [3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.0, 2.0, 2.0]
    for grads, v in zip(_grad_sequence(len(values), shapes, 1), values):
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                jparams, value=jnp.float32(v))
        jparams = optax.apply_updates(jparams, upd)
        params[0].grad = torch.from_numpy(grads[0])
        opt.step(value=torch.tensor(v))
        np.testing.assert_allclose(params[0].detach().numpy(),
                                   np.asarray(jparams[0]), rtol=1e-5,
                                   atol=1e-7)
        assert plateau_scale(opt) == jsched.plateau_scale(jstate)
    assert plateau_scale(opt) < 1.0
    with pytest.raises(ValueError, match="value=loss"):
        params[0].grad = torch.ones(4)
        opt.step()


def test_adam_state_dict_round_trip():
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = Adam(p, 1e-2, plateau=plateau_kwargs(2))
    for v in (2.0, 1.0, 1.0):
        p[0].grad = torch.full((3,), v)
        opt.step(value=torch.tensor(v))
    # A deep copy, as a checkpoint file gives: the live state_dict
    # shares the moment buffers, which steps update in place.
    sd = copy.deepcopy(opt.state_dict())
    q = [torch.nn.Parameter(p[0].detach().clone())]
    opt2 = Adam(q, 1e-2, plateau=plateau_kwargs(2))
    opt2.load_state_dict(sd)
    for o, par in ((opt, p), (opt2, q)):
        par[0].grad = torch.full((3,), 0.5)
        o.step(value=torch.tensor(0.5))
    assert torch.equal(p[0], q[0]) and opt2.count == 4
    with pytest.raises(ValueError, match="plateau"):
        Adam([torch.nn.Parameter(torch.ones(3))], 1e-2).load_state_dict(sd)
