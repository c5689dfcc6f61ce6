"""Training CLI for the VISinger GAN on one device.

Usage:
  python -m music_generation_tpu_torch.train --steps 1000 --ckpt-dir ./ckpts \
      [--data-dir NPY_DIR | --packed PREFIX] [--log-images]
      [--tiny] [--durations mas] [--decoder hifigan|istft|mb_istft]
      [--nsf] [--f0-residual] [--bf16] [--device cpu]
      [--multihost [--coordinator HOST:PORT --nprocs N --proc-id I]
       [--n-model M]]

Twin of ``python -m music_generation_tpu.train``, with random-init
weights. Batches come from a preprocessed corpus,
``--data-dir`` (train.dataset.NpyDataset: the npy directory that
``python -m music_generation_tpu_torch.train.dataset`` or ``.toydata``
writes) or ``--packed`` (train.dataset.PackedDataset: PREFIX.data/.idx from
pack_dataset, either package's), seeded by the process's rank as the JAX
CLI seeds them, with the learning rate decayed once per epoch of
len(dataset) // batch-size steps; else synthetic batches
(train.data.synthetic_batch, seeded step * nprocs + rank).
``--log-images`` writes
the debug images of each logged step under <ckpt-dir>/logs/images.
Runs on ``cuda`` unless given ``--device``; it never falls back to the CPU.
``--durations mas`` aligns each step with monotonic alignment search, which
on a CUDA device launches the hand-written kernel. ``--bf16`` computes
both networks from bfloat16 casts of their float32 masters
(TrainConfig.bf16_run).

``--multihost`` runs one process per device: every process runs this
command and joins a torch.distributed group (NCCL on CUDA, gloo with
``--device cpu``) at ``--coordinator`` with ``--nprocs`` and
``--proc-id``, or from torchrun's environment. ``--batch-size`` is per
process: the global batch is nprocs x batch-size, and a step equals the
one-process step on it (train.trainer). ``--n-model M`` shards the large
weights and their Adam moments over groups of M processes
(parallel.ShardedParams); it needs ``--multihost``, since one process
drives one device. Only process 0 writes metrics, best.json and
checkpoints, which are the files one device writes.
``tools/torch_export_trained_svs.py`` turns a step_<n>.pt into the
per-singer files ``serve.app --checkpoint-dir`` serves.
"""

import argparse
import dataclasses
import os
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m music_generation_tpu_torch."
                                     "train")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--ckpt-dir", default="./checkpoints")
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--keep-last", type=int, default=3,
                   help="retain only the newest N checkpoints (+ best loss)")
    p.add_argument("--accumulate-grad-batches", type=int, default=1,
                   help="apply optimizer updates every N steps (averaged "
                        "grads)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--resume", default=None, metavar="FILE",
                   help="a step_<n>.pt checkpoint; --steps are additional")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    corpus = p.add_mutually_exclusive_group()
    corpus.add_argument("--data-dir", default=None,
                        help="preprocessed npy corpus directory "
                             "(train.dataset / train.toydata output)")
    corpus.add_argument("--packed", default=None, metavar="PREFIX",
                        help="packed indexed corpus PREFIX.data/.idx (see "
                             "train.dataset pack_dataset)")
    p.add_argument("--log-images", action="store_true",
                   help="write spectrogram and alignment heatmaps with each "
                        "metrics log (PNGs, or .npy without matplotlib, "
                        "under <ckpt-dir>/logs/images; TensorBoard when "
                        "installed)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="prefetch depth: assemble + copy the next N batches "
                        "on a background thread (0 = synchronous)")
    p.add_argument("--durations", default="dataset",
                   choices=["dataset", "mas"],
                   help="phone-duration source for the length regulator: "
                        "the dataset's, or in-step monotonic alignment "
                        "search (the CUDA kernel on a GPU)")
    p.add_argument("--disc-lr-scale", type=float, default=1.0)
    for flag in ("c-kl-rev", "c-adv", "c-fm", "c-stft", "c-energy", "c-spec",
                 "c-mel", "lr", "grad-clip-norm", "c-dc", "disc-loss-floor",
                 "disc-input-noise"):
        p.add_argument(f"--{flag}", type=float, default=None,
                       help="see TrainConfig (default: its value)")
    p.add_argument("--warmup-steps", type=int, default=200,
                   help="linear LR warmup steps (0 disables)")
    p.add_argument("--decoder", default="hifigan",
                   choices=["hifigan", "istft", "mb_istft"])
    p.add_argument("--nsf", action="store_true",
                   help="NSF harmonic excitation: condition the vocoder on "
                        "a sample-rate sine source at the batch's F0 "
                        "(models/svs/excitation.py; --decoder hifigan only)")
    p.add_argument("--f0-residual", action="store_true",
                   help="residual F0 head: the zero-initialised predictor "
                        "output is a deviation added to the score note's "
                        "log-F0 (SVSConfig.f0_residual)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bfloat16 compute from float32 "
                        "masters (TrainConfig.bf16_run)")
    p.add_argument("--multihost", action="store_true",
                   help="one process per device in a torch.distributed "
                        "group (every process runs this command); "
                        "--batch-size is PER PROCESS: the global batch is "
                        "nprocs x batch-size")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address (tcp://); without it the "
                        "group comes from torchrun's environment")
    p.add_argument("--nprocs", type=int, default=None,
                   help="process count for --coordinator")
    p.add_argument("--proc-id", type=int, default=None,
                   help="this process's rank for --coordinator")
    p.add_argument("--n-model", type=int, default=1,
                   help="model-axis width: the large weights sharded over "
                        "groups of this many processes (needs --multihost)")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if not args.multihost:
        for flag in ("coordinator", "nprocs", "proc_id"):
            if getattr(args, flag) is not None:
                p.error(f"--{flag.replace('_', '-')} needs --multihost")
        if args.n_model != 1:
            p.error("--n-model > 1 needs --multihost: one process drives "
                    "one device, so the model axis spans processes")
    elif args.coordinator and (args.nprocs is None or args.proc_id is None):
        p.error("--coordinator needs --nprocs and --proc-id")
    elif not args.coordinator:
        unset = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                             "MASTER_PORT") if v not in os.environ]
        if unset:
            p.error(f"--multihost without --coordinator takes the group "
                    f"from torchrun's environment; unset: {', '.join(unset)}")

    import torch

    from ..device import resolve_device
    from ..runtime import Prefetcher
    from .configs import build_svs_config, tool_shapes
    from .data import synthetic_batch, to_device
    from .metrics import MetricsWriter
    from .trainer import (TrainConfig, create_states, distribute_states,
                          make_train_step, restore_checkpoint,
                          save_checkpoint)

    try:
        svs_cfg = build_svs_config(tiny=args.tiny, decoder=args.decoder,
                                   nsf=args.nsf, f0_residual=args.f0_residual)
    except ValueError as e:
        p.error(str(e))
    device = resolve_device(args.device)
    t_phones, t_frames = tool_shapes(args.tiny)
    mesh, rank, nprocs = None, 0, 1
    if args.multihost:
        from ..parallel import (StepMesh, init_distributed, local_device,
                                make_hybrid_mesh, mesh_shape,
                                put_global_batch)
        rank, nprocs = init_distributed(device.type, args.coordinator,
                                        args.nprocs, args.proc_id)
        print(f"process {rank}/{nprocs}")
        device = local_device(device.type)
        try:
            dmesh = make_hybrid_mesh(args.n_model, device.type)
        except ValueError as e:
            p.error(str(e))
        mesh = StepMesh.from_mesh(dmesh)
        if rank == 0:
            print(f"mesh: {mesh_shape(dmesh)} over {nprocs} devices")
    proc0 = rank == 0

    tcfg = TrainConfig(accumulate_grad_batches=args.accumulate_grad_batches,
                       use_mas=args.durations == "mas",
                       disc_lr_scale=args.disc_lr_scale,
                       warmup_steps=args.warmup_steps,
                       log_images=args.log_images, bf16_run=args.bf16)
    for field, val in (("c_kl_rev", args.c_kl_rev), ("c_adv", args.c_adv),
                       ("c_fm", args.c_fm), ("c_mel", args.c_mel),
                       ("c_stft", args.c_stft), ("c_energy", args.c_energy),
                       ("c_spec", args.c_spec), ("learning_rate", args.lr),
                       ("grad_clip_norm", args.grad_clip_norm),
                       ("c_dc", args.c_dc),
                       ("disc_loss_floor", args.disc_loss_floor),
                       ("disc_input_noise", args.disc_input_noise)):
        if val is not None:
            tcfg = dataclasses.replace(tcfg, **{field: val})

    dataset = None
    if args.packed or args.data_dir:
        from .dataset import NpyDataset, PackedDataset
        # each process samples its own stream, seeded by its rank
        source, cls = ((args.packed, PackedDataset) if args.packed
                       else (args.data_dir, NpyDataset))
        dataset = cls(source, svs_cfg, t_phones=t_phones, t_frames=t_frames,
                      seed=rank)
        if not len(dataset):
            p.error(f"no utterances in {source}")
        # the reference decays the LR once per epoch (ExponentialLR with
        # configs/ours.json's lr_decay)
        tcfg = dataclasses.replace(tcfg, steps_per_epoch=max(
            1, len(dataset) // args.batch_size))
        if proc0:
            print(f"dataset: {len(dataset)} utterances from {source} "
                  f"({'packed' if args.packed else 'npy'}); steps_per_epoch "
                  f"{tcfg.steps_per_epoch}")

    def next_batch(step):
        if dataset is not None:
            return dataset.batch(args.batch_size)
        return synthetic_batch(svs_cfg, batch=args.batch_size,
                               t_phones=t_phones, t_frames=t_frames,
                               seed=step * nprocs + rank)

    gen_state, disc_state = create_states(svs_cfg, tcfg, device)
    start_step = 0
    if args.resume:
        restore_checkpoint(args.resume, gen_state, disc_state)
        # --steps are ADDITIONAL steps: number checkpoints and metrics on
        # from the restored step so a same-dir resume extends the run
        start_step = gen_state.step
        print(f"resumed from {args.resume} at step {start_step}")
    if mesh is not None:
        distribute_states(gen_state, disc_state, mesh)
    train_step = make_train_step(svs_cfg, tcfg, mesh)
    # seeded alike on every process: each draws the global noise
    generator = torch.Generator(device).manual_seed(tcfg.seed)
    # the metrics are global values, the same on every process: process 0
    # writes them
    writer = (MetricsWriter(os.path.join(args.ckpt_dir, "logs")) if proc0
              else None)
    ckpt_dir = os.path.abspath(args.ckpt_dir)

    def transfer(b):
        if mesh is not None:
            return put_global_batch(b, device)
        return to_device(b, device)

    feed = None
    if args.prefetch > 0:
        feed = Prefetcher(next_batch, args.steps, depth=args.prefetch,
                          transfer=transfer)
        batches = iter(feed)
    else:
        batches = ((s, transfer(next_batch(s))) for s in range(args.steps))
    t0 = time.time()
    metrics = None
    try:
        for step, batch in batches:
            metrics = train_step(gen_state, disc_state, batch, generator)
            if step % args.log_every == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()
                     if v.ndim == 0}
                print(f"step {start_step + step} ({time.time() - t0:.1f}s): "
                      f"{m}")
                if writer is not None:
                    writer.write(start_step + step, metrics)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                save_checkpoint(ckpt_dir, gen_state, disc_state,
                                start_step + step, keep_last=args.keep_last,
                                metric=float(metrics["loss_mel"]),
                                write=proc0)
    finally:
        if feed is not None:  # stop the producer on a consumer error too
            feed.close()
        if writer is not None:
            writer.close()
        if hasattr(dataset, "close"):  # a PackedDataset's mapped file
            dataset.close()
    save_checkpoint(ckpt_dir, gen_state, disc_state, start_step + args.steps,
                    keep_last=args.keep_last,
                    metric=(float(metrics["loss_mel"])
                            if metrics is not None else None), write=proc0)
    total = time.time() - t0
    print(f"done: {args.steps} steps in {total:.1f}s "
          f"({args.steps * args.batch_size * nprocs / total:.2f} samples/s)")
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()  # process 0's files are written before any exits
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
