"""Configuration, the inference chains, the diffusion sampler, the GAN
train step, the refiner's train steps and the mesh of the port."""

from .config import TrainConfig
from .infer import make_infer_fn
from .preprocess import preprocess, preprocess_with_mask
from .diffusion import (RefineNoise, ddim_refine, ddim_refine_complex,
                        make_complex_refiner_infer_fn,
                        make_complex_refiner_train_step,
                        make_refiner_train_step)
from .mesh import (Mesh, batch_sharding, global_batch_from_local, make_mesh,
                   maybe_initialize_distributed, replicate, shard_batch,
                   shard_params)
from .pool import draw_pool, init_pool, query_pool
from .schedules import (Adam, ReduceOnPlateau, adam, cosine, lambda_linear,
                        make_schedule, optimizer_step, plateau_kwargs,
                        plateau_scale, step_decay)
from .step import init_state, make_train_step

__all__ = [
    "TrainConfig", "make_infer_fn", "preprocess", "preprocess_with_mask",
    "init_pool", "draw_pool", "query_pool", "Adam", "ReduceOnPlateau",
    "adam", "lambda_linear", "step_decay", "cosine", "make_schedule",
    "plateau_kwargs", "plateau_scale", "optimizer_step", "init_state",
    "make_train_step", "RefineNoise", "ddim_refine", "ddim_refine_complex",
    "make_complex_refiner_infer_fn", "make_refiner_train_step",
    "make_complex_refiner_train_step", "Mesh", "make_mesh",
    "batch_sharding", "shard_batch", "replicate", "shard_params",
    "maybe_initialize_distributed", "global_batch_from_local",
]
