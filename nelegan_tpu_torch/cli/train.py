"""Training CLI: the reference's `python train_nele.py` with flags instead of
edited source (reference: train_nele.py:30-68, README.md:43).

Counterpart of `nelegan_tpu/cli/train.py`, with `--device` (default
`cuda`; without a GPU pass `cpu`) in place of `--platform`:

    python -m nelegan_tpu_torch.cli.train \\
        --train-clean .../Train/Clean --train-noise .../Train/Noise \\
        --test-clean .../Test/Clean --test-noise .../Test/Noise \\
        [--train-enhanced .../Train/MultiEnh] [--epochs 500] [--resume] \\
        [--device cuda]

`--compute-dtype bfloat16` trains under the models' mixed-precision policy
(bfloat16 trunks; parameters and checkpoints stay float32).

Data parallelism: one process a GPU, started by torchrun, each rank
training on its rows of every batch (`parallel/mesh.py`):

    torchrun --nproc-per-node 4 -m nelegan_tpu_torch.cli.train \\
        --data-parallel ...        # or python -m torch.distributed.run

Each rank joins the world from torchrun's environment, on CUDA device
LOCAL_RANK over NCCL (`--device cpu`: gloo); a backend that cannot start
fails the rank.  Only rank 0 writes the run's files.  `--data-parallel`
without torchrun trains on one device, and raises with more than one GPU
visible.  Every run sets deterministic cuDNN (and TF32 off), so that a
resumed run continues bit for bit.

Recovery: `--max-retries N` rebuilds and resumes the trainer in-process
(`train/resilience.run_with_recovery`).  In a torchrun world the agent
restarts the whole world instead, and every rank of a restarted attempt
resumes the latest checkpoint (`resume_after_restart`); torchrun must
allow at least N restarts, or the CLI refuses:

    torchrun --standalone --nproc-per-node 2 --max-restarts 1 \\
        -m nelegan_tpu_torch.cli.train --data-parallel --max-retries 1 ...
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-clean", required=True)
    p.add_argument("--train-noise", required=True)
    p.add_argument("--test-clean", required=True)
    p.add_argument("--test-noise", required=True)
    p.add_argument("--train-enhanced", default=None,
                   help="pre-enhanced (e.g. SSDRC) parallel corpus for D")
    p.add_argument("--output", default="./output")
    p.add_argument("--checkpoints", default="./chkpt")
    p.add_argument("--log-file", default="./log.txt")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--num-sampling", type=int, default=300)
    p.add_argument("--num-valid", type=int, default=480)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--lr-g", type=float, default=5e-4)
    p.add_argument("--lr-d", type=float, default=2.5e-4)
    p.add_argument("--weight-qua", type=float, default=0.5)
    p.add_argument("--metrics", default="siib,haspi,estoi,pesq,visqol")
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="model trunk activation dtype (bf16 mixed "
                        "precision; params/checkpoints stay f32)")
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallelism over the ranks of a torchrun "
                        "world (torchrun --nproc-per-node N -m "
                        "nelegan_tpu_torch.cli.train --data-parallel ...)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--max-retries", type=int, default=0,
                   help="elastic recovery: on failures, rebuild the "
                        "trainer, resume from the latest checkpoint and "
                        "continue (up to N extra attempts); in a torchrun "
                        "world torchrun's --max-restarts (at least N) "
                        "restarts the world and every rank resumes")
    p.add_argument("--init-from-torch", default=None,
                   help="reference chkpt_GD.pt to initialise from")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    p.add_argument("--verbose-timing", action="store_true",
                   help="print per-epoch phase timing deltas")
    return p


def join_world(device: str):
    """Join the torchrun world this process was started in (its env://
    variables) -> this rank's device: CUDA device LOCAL_RANK over NCCL, or
    with a CPU `device` the CPU over gloo.  No fallback: a backend that
    cannot start raises.

    torchrun's agent keeps one store across the restarts of a world, so a
    restarted attempt's ranks would find the failed attempt's addresses
    there and connect to dead peers: each attempt keys its group under a
    prefix of its own."""
    import torch
    import torch.distributed as dist

    from nelegan_tpu_torch.device import resolve_device
    from nelegan_tpu_torch.parallel.mesh import local_cuda_device
    from nelegan_tpu_torch.train.resilience import restart_count

    store, rank, world = next(dist.rendezvous("env://"))
    store = dist.PrefixStore(f"attempt_{restart_count()}", store)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(local_cuda_device())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world)
    return dev


def main(argv=None):
    """Runs the CLI; returns the trainer of the last attempt."""
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
    from nelegan_tpu_torch.device import disable_tf32, resolve_device
    from nelegan_tpu_torch.train import resilience
    from nelegan_tpu_torch.train.loop import Trainer, TrainPaths

    world = args.data_parallel and "WORLD_SIZE" in os.environ
    if world and args.max_retries > 0:
        resilience.check_restart_budget(args.max_retries)
    device = join_world(args.device) if world else resolve_device(args.device)
    # per process: spawned or torchrun ranks do not inherit them
    disable_tf32()
    torch.backends.cudnn.deterministic = True
    cfg = Config(train=TrainConfig(
        gan_epochs=args.epochs, num_sampling=args.num_sampling,
        num_valid=args.num_valid, batch_size=args.batch_size,
        seed=args.seed, lr_g=args.lr_g, lr_d=args.lr_d,
        lr_dqua=args.lr_d, weight_qua=args.weight_qua),
        model=ModelConfig(compute_dtype=args.compute_dtype))
    paths = TrainPaths(
        train_clean=args.train_clean, train_noise=args.train_noise,
        test_clean=args.test_clean, test_noise=args.test_noise,
        train_enhanced=args.train_enhanced, output=args.output,
        checkpoints=args.checkpoints, log_file=args.log_file)

    metrics = tuple(m.strip() for m in args.metrics.split(",") if m.strip())

    def make_trainer(resume=args.resume):
        trainer = Trainer(paths, cfg, metric_set=metrics,
                          data_parallel=args.data_parallel, device=device)
        if args.init_from_torch:
            from nelegan_tpu_torch.train.checkpoint import (
                load_reference_checkpoint)
            trainer.state = load_reference_checkpoint(args.init_from_torch,
                                                      trainer.state)
            print(f"initialised from {args.init_from_torch}")
        if resume:
            trainer.resume(truncate_log=True)
            print(f"resumed at epoch {trainer.start_epoch}")
        return trainer

    if not world and args.max_retries > 0:
        return resilience.run_with_recovery(
            make_trainer, args.epochs, max_retries=args.max_retries,
            verbose_timing=args.verbose_timing)
    try:
        # a restarted world resumes its latest checkpoint, not --resume's
        restarted = (world and args.max_retries > 0
                     and resilience.restart_count() > 0)
        trainer = make_trainer(resume=args.resume and not restarted)
        if restarted:
            resilience.resume_after_restart(trainer)
        trainer.run(args.epochs, verbose_timing=args.verbose_timing)
    finally:
        if world:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
