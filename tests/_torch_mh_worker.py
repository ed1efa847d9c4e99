"""Subprocess worker of tests/test_torch_mesh.py's two-process run (not
a test).

Launched twice (ranks 0 and 1) on the CPU; maybe_initialize_distributed
wires them with gloo into one process group, the port's counterpart of
tests/_mh_worker.py. Each claim of __graft_entry__.py::dryrun_multichip
runs over the 2-rank mesh and, in the same process without a mesh, on
the global batch (the single-process reference); both results go to
`{out}.{rank}.npz` for the test to compare:

  c1  one SGD GAN step, data-parallel (2 x 1), from the weights, batch
      and gap masks the test wrote (use_video, FM loss, hole_weight 2);
  c2  three Adam GAN steps (2 x 1), draws from one generator;
  c3  one refiner SGD step in each domain (2 x 1);
  c4  the serving chain of an ensemble of two Gs with the magnitude
      refiner (refine_avg 2), a request of 3 clips in a bucket of 4;
  c5  one SGD GAN step with the optimizers sharded over a model axis of
      2 (1 x 2, min_shard 1), then one Adam step whose gathered state
      must be the unsharded one;
  c6  two SGD GAN steps with batch-norm G (dropout 0.5) and D and an
      ImagePool of 4 (2 x 1);
  c7  the train CLI over both ranks (2 x 1): two Adam steps at a global
      batch of 4, visuals and the checkpoint on rank 0 (the test runs the
      same command in one process).
"""

import copy
import dataclasses
import os
import sys

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from viai_tpu_torch import InpaintService  # noqa: E402
from viai_tpu_torch.io import flat_from_state  # noqa: E402
from viai_tpu_torch.nn import (DiscriminatorConfig, GeneratorConfig,  # noqa: E402
                               PatchDiscriminator, UNetGenerator, define_R)
from viai_tpu_torch.testing import TINY_CFG, tiny_models, tone_batch  # noqa: E402
from viai_tpu_torch.train import (adam, init_state, make_train_step,  # noqa: E402
                                  make_complex_refiner_train_step,
                                  make_refiner_train_step)
from viai_tpu_torch.train.diffusion import complex_refiner_channels  # noqa: E402
from viai_tpu_torch.train.mesh import (global_batch_from_local,  # noqa: E402
                                       make_mesh,
                                       maybe_initialize_distributed,
                                       replicate, shard_batch, shard_params)

assert maybe_initialize_distributed(f"localhost:{port}", world, rank,
                                    device="cpu")
dp = make_mesh(devices="cpu")
assert dp.shape == {"data": 2, "model": 1} and dp.data_index == rank
res = {}
B = 4                                    # global batch, 2 rows a rank
CFG1 = dataclasses.replace(TINY_CFG, use_video=True, lambda_fm=1.0,
                           hole_weight=2.0)


def flat(*mods):
    return np.concatenate([v.numpy().ravel() for m in mods
                           for v in flat_from_state(m).values()])


def clips(seed):
    w = tone_batch(B, seed=seed)
    return w + 0.01 * np.random.default_rng(seed + 1).standard_normal(
        w.shape).astype(np.float32)


def gan(mesh, nets, cfg, opt_kind, steps, wav, frames=None, draws=None,
        seed=0, min_shard=8):
    """`steps` GAN steps on copies of nets = (G, D, V) → (flat G, V, D
    after, losses a step, the modules and optimizers, the state)."""
    G, D, V = (None if n is None else copy.deepcopy(n) for n in nets)
    gv = list(G.parameters()) + (list(V.parameters()) if V else [])
    if opt_kind == "sgd":
        g_opt = torch.optim.SGD(gv, lr=0.1)
        d_opt = torch.optim.SGD(D.parameters(), lr=0.05)
    else:
        g_opt, d_opt = adam(gv, 2e-4), adam(D.parameters(), 2e-4)
    if mesh is not None:
        placed = shard_params({"G": G, "D": D, "V": V, "g": g_opt,
                               "d": d_opt}, mesh, min_shard=min_shard)
        g_opt, d_opt = placed["g"], placed["d"]
    state = init_state(D, cfg)
    step = make_train_step(G, D, V, g_opt, d_opt, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    if mesh is not None:
        wav = shard_batch(wav, mesh)
        frames = None if frames is None else shard_batch(frames, mesh)
    else:
        wav = torch.as_tensor(wav)
        frames = None if frames is None else torch.as_tensor(frames)
    losses = []
    for _ in range(steps):
        m = step(state, wav, frames, gen, **(draws or {}))
        losses.append([float(m[k]) for k in sorted(m)])
    mods = [G] + ([V] if V else []) + [D]
    return flat(*mods), np.array(losses), (G, D, V, g_opt, d_opt), state


# c1: the SGD step from the test's weights, batch and masks.
init = torch.load(f"{out}.init.pt", weights_only=True)
nets = tiny_models(use_video=True, device="cpu")
for net, name in zip(nets, "GDV"):
    net.load_state_dict(init[name])
rows = global_batch_from_local(init["wav"][2 * rank: 2 * rank + 2], dp)
assert torch.equal(rows, shard_batch(init["wav"], dp))
draws = {"tmask": init["tmask"]}
res["c1_single"], res["c1_single_loss"], _, _ = gan(
    None, nets, CFG1, "sgd", 1, init["wav"], init["frames"], draws=draws)
res["c1_dp"], res["c1_dp_loss"], (Gd, Dd, Vd, _, _), _ = gan(
    dp, nets, CFG1, "sgd", 1, init["wav"], init["frames"], draws=draws)
for name, mod in (("G", Gd), ("V", Vd), ("D", Dd)):
    for k, v in flat_from_state(mod).items():
        res[f"c1/{name}/{k}"] = v.numpy()

# c2: three Adam steps, draws from one generator.
nets = tiny_models(use_video=True, seed=0, device="cpu")
fr = np.random.default_rng(5).uniform(0, 1, (B, 8, 16, 16, 3)).astype(
    np.float32)
wav = clips(3)
res["c2_single"], res["c2_single_loss"], _, _ = gan(
    None, nets, CFG1, "adam", 3, wav, fr, seed=7)
res["c2_dp"], res["c2_dp_loss"], _, _ = gan(
    dp, nets, CFG1, "adam", 3, wav, fr, seed=7)


# c3: one refiner SGD step in each domain.
def perturbed_R(in_ch, out_ch, seed):
    R = define_R(in_ch, 8, seed=seed, out_channels=out_ch, device="cpu")
    rng = np.random.default_rng(300 + seed)
    with torch.no_grad():
        for p in R.parameters():
            p += torch.from_numpy(
                0.02 * rng.standard_normal(p.shape).astype(np.float32))
    return R


def refiner_step(mesh, make_step, R0, seed):
    G = tiny_models(seed=0, device="cpu")[0]
    R = copy.deepcopy(R0)
    if mesh is not None:
        replicate([G, R], mesh)
    stp = make_step(G, None, R, copy.deepcopy(R),
                    torch.optim.SGD(R.parameters(), lr=1e-2), TINY_CFG,
                    mesh=mesh)
    w = torch.from_numpy(clips(9))
    if mesh is not None:
        w = shard_batch(w, mesh)
    m = stp(w, torch.Generator().manual_seed(seed))
    return flat(R), float(m["loss_R"])


r_in, r_out = complex_refiner_channels(2)
for tag, make_step, R0, seed in (
        ("mag", make_refiner_train_step, perturbed_R(4, 1, 1), 11),
        ("complex", make_complex_refiner_train_step,
         perturbed_R(r_in, r_out, 2), 12)):
    for side, mesh in (("single", None), ("dp", dp)):
        res[f"c3_{tag}_{side}"], loss = refiner_step(mesh, make_step, R0,
                                                     seed)
        res[f"c3_{tag}_{side}_loss"] = np.array(loss)


# c4: the ensemble (+ magnitude refiner) serving chain.
def service(mesh):
    gens = [tiny_models(seed=s, device="cpu")[0] for s in (0, 3)]
    return InpaintService(gens[0], TINY_CFG, buckets=(4,), gl_iters=2,
                          clip_samples=4032, ensemble_states=gens[1:],
                          refiner=perturbed_R(4, 1, 1), refine_steps=2,
                          refine_avg=2, refine_chunk=1, device="cpu",
                          mesh=mesh)


masks = np.ones((3, TINY_CFG.image_frames), np.float32)
masks[:, 20:36] = 0.0
req = clips(13)[:3]
res["c4_single"] = service(None).inpaint(req, masks=masks)
res["c4_dp"] = service(dp).inpaint(req, masks=masks)

# c5: the optimizers sharded over a model axis of 2.
mp = make_mesh(n_data=1, n_model=2, devices="cpu")
assert mp.shape == {"data": 1, "model": 2} and mp.model_index == rank
nets = tiny_models(use_video=True, seed=0, device="cpu")
res["c5_single"], res["c5_single_loss"], _, _ = gan(
    None, nets, CFG1, "sgd", 1, wav, fr, seed=5)
res["c5_mp"], res["c5_mp_loss"], _, _ = gan(
    mp, nets, CFG1, "sgd", 1, wav, fr, seed=5, min_shard=1)
_, _, (_, _, _, g_single, _), _ = gan(None, nets, CFG1, "adam", 1, wav, fr,
                                      seed=5)
_, _, (_, _, _, g_mp, _), _ = gan(mp, nets, CFG1, "adam", 1, wav, fr, seed=5,
                                  min_shard=1)
assert g_mp.shards, "nothing was sharded"
res["c5_n_sharded"] = np.array(len(g_mp.shards))
for name, o in (("single", g_single), ("mp", g_mp)):
    sd = o.state_dict()
    res[f"c5_adam_{name}"] = np.concatenate(
        [sd["state"][i][k].numpy().ravel() for i in sorted(sd["state"])
         for k in ("mu", "nu")])
# The gathered state loads into a fresh sharded optimizer as it was.
_, _, (_, _, _, g_fresh, _), _ = gan(mp, nets, CFG1, "adam", 0, wav, fr,
                                     min_shard=1)
g_fresh.load_state_dict(sd)
again = g_fresh.state_dict()
assert again["count"] == sd["count"] == 1
assert all(torch.equal(again["state"][i][k], sd["state"][i][k])
           for i in sd["state"] for k in ("mu", "nu"))

# c6: batch-norm G (dropout 0.5) and D, a pool of 4, two SGD steps.
gen = torch.Generator().manual_seed(0)
G6 = UNetGenerator(GeneratorConfig(ngf=8, strides=((2, 2), (2, 2), (2, 1)),
                                   mults=(1, 2, 4), norm="batch",
                                   dropout=0.5), gen)
D6 = PatchDiscriminator(DiscriminatorConfig(in_channels=3, ndf=8,
                                            n_layers=2, norm="batch"), gen)
CFG6 = dataclasses.replace(TINY_CFG, pool_size=4)
for side, mesh in (("single", None), ("dp", dp)):
    res[f"c6_{side}"], res[f"c6_{side}_loss"], _, st = gan(
        mesh, (G6, D6, None), CFG6, "sgd", 2, wav, seed=21)
    res[f"c6_{side}_pool"] = st["pool"]["buf"].numpy()

# c7: the train CLI, data-parallel.
from viai_tpu_torch.cli.train import main as train_main  # noqa: E402

model = train_main(sys.argv[5:] + ["--name", "dp", "--n_data_devices", "2"])
assert model.mesh.shape == {"data": 2, "model": 1}
assert model._input["wav"].shape[0] == 2

np.savez(f"{out}.{rank}.npz", **res)
print(f"worker {rank} done", flush=True)
