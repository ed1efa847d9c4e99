"""Train the port's model — the reference's training entry point.

Port of `viai_tpu/cli/train.py`: parse options → data loader →
create_model → epoch/step loop over the batches prefetched to the
device (data/prefetch.py) → set_input → optimize_parameters →
periodic visuals, prints and saves (`latest` and per epoch) → the lr
report per epoch.

    python -m viai_tpu_torch.cli.train --name exp --model audio \\
        --dataset_mode synthetic --niter 2 --niter_decay 0 --batchSize 16

--gpu_ids -1 trains on the CPU; otherwise the card. On several cards,
one process each (NCCL; gloo on the CPU), every rank reading the same
global batches:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m viai_tpu_torch.cli.train --name exp --batchSize 64 ...

The mesh is --n_data_devices x --n_model_devices ranks (0 data devices
= the world's size); rank 0 prints, writes the visuals and saves.
"""

from __future__ import annotations

import os
import time

import torch.distributed as dist

from ..config.options import TrainOptions, device_from_opt
from ..data import create_dataloader
from ..data.prefetch import device_prefetch
from ..model import create_model
from ..train.mesh import maybe_initialize_distributed
from ..utils.compile_cache import enable as enable_build_cache
from ..utils.visualizer import Visualizer


def main(args=None):
    enable_build_cache()
    opt = TrainOptions().parse(args)
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    maybe_initialize_distributed(device=device_from_opt(opt).type)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0

    clip_samples = int(opt.sample_rate * opt.clip_seconds)
    loader = create_dataloader(
        opt.dataset_mode, opt.dataroot, opt.batchSize, clip_samples,
        opt.sample_rate, opt.nThreads, opt.n_video_frames, opt.frame_size,
        seed=opt.seed, shuffle=not opt.serial_batches,
    )
    steps_per_epoch = opt.steps_per_epoch
    if steps_per_epoch <= 0:
        # Loaders advertise their batches per epoch; 100 otherwise.
        steps_per_epoch = getattr(loader, "epoch_batches", 100)
    opt.steps_per_epoch = steps_per_epoch

    try:
        model = create_model(opt)
        if opt.continue_train:
            model.load_networks(opt.which_epoch)
        visualizer = (Visualizer(expr_dir, opt.name,
                                 tensorboard=getattr(opt, "tensorboard",
                                                     False))
                      if main_rank else None)

        total_steps = 0

        def fresh_iter():
            # Batches copied to the device two steps ahead of the step.
            return device_prefetch(iter(loader), model.device, depth=2)

        data_iter = fresh_iter()
        for epoch in range(opt.epoch_count, opt.niter + opt.niter_decay + 1):
            epoch_start = time.time()
            for i in range(steps_per_epoch):
                step_start = time.time()
                try:
                    batch = next(data_iter)
                except StopIteration:
                    data_iter = fresh_iter()
                    batch = next(data_iter)
                model.set_input(batch)
                model.optimize_parameters()
                total_steps += 1
                if not opt.no_html and total_steps % opt.display_freq == 0:
                    # Every rank runs the chain (a synced batch norm
                    # takes part in a collective); rank 0 writes.
                    visuals = model.get_current_visuals()
                    if main_rank:
                        visualizer.display_current_results(visuals, epoch)
                if main_rank and total_steps % opt.print_freq == 0:
                    visualizer.print_current_losses(
                        epoch, i, model.get_current_losses(),
                        time.time() - step_start)
                if total_steps % opt.save_latest_freq == 0:
                    print(f"saving latest (epoch {epoch}, steps "
                          f"{total_steps})")
                    model.save_networks("latest")
            if epoch % opt.save_epoch_freq == 0:
                print(f"saving epoch {epoch} (steps {total_steps})")
                model.save_networks(epoch)
                model.save_networks("latest")
            print(f"End of epoch {epoch} / {opt.niter + opt.niter_decay} \t "
                  f"Time: {time.time() - epoch_start:.1f}s")
            model.update_learning_rate()
        model.save_networks("latest")
    finally:
        if hasattr(loader, "close"):
            loader.close()
    return model


if __name__ == "__main__":
    main()
