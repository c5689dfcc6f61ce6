"""Training CLI for the VISinger GAN on one device.

Usage:
  python -m music_generation_tpu_torch.train --steps 1000 --ckpt-dir ./ckpts \
      [--tiny] [--durations mas] [--device cpu]

Twin of ``python -m music_generation_tpu.train`` on synthetic batches
(train.data.synthetic_batch, seeded by the step) with random-init weights.
Runs on ``cuda`` unless given ``--device``; it never falls back to the CPU.
``--durations mas`` aligns each step with monotonic alignment search, which
on a CUDA device launches the hand-written kernel. Flags of the JAX CLI
that are not ported yet (--bf16, --data-dir, --packed, --multihost,
--n-model > 1, --log-images, --nsf, --f0-residual, the iSTFT decoders)
exit with an error that names them.
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
    # flags of the JAX CLI that the port does not implement yet
    for flag in ("bf16", "log-images", "nsf", "f0-residual", "multihost"):
        p.add_argument(f"--{flag}", action="store_true",
                       help="not yet ported")
    for flag in ("data-dir", "packed", "coordinator"):
        p.add_argument(f"--{flag}", default=None, help="not yet ported")
    p.add_argument("--nprocs", type=int, default=None, help="not yet ported")
    p.add_argument("--proc-id", type=int, default=None,
                   help="not yet ported")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel width; only 1 is ported")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    for name in ("bf16", "log_images", "multihost", "data_dir", "packed",
                 "coordinator", "nprocs", "proc_id"):
        if getattr(args, name) not in (None, False):
            p.error(f"--{name.replace('_', '-')} is not yet ported")
    if args.n_model != 1:
        p.error("--n-model > 1 is not yet ported")

    import torch

    from ..device import resolve_device
    from ..runtime import Prefetcher
    from .configs import build_svs_config, tool_shapes
    from .data import synthetic_batch, to_device
    from .metrics import MetricsWriter
    from .trainer import (TrainConfig, create_states, make_train_step,
                          restore_checkpoint, save_checkpoint)

    try:
        svs_cfg = build_svs_config(tiny=args.tiny, decoder=args.decoder,
                                   nsf=args.nsf, f0_residual=args.f0_residual)
    except NotImplementedError as e:
        p.error(str(e))
    device = resolve_device(args.device)
    t_phones, t_frames = tool_shapes(args.tiny)

    tcfg = TrainConfig(accumulate_grad_batches=args.accumulate_grad_batches,
                       use_mas=args.durations == "mas",
                       disc_lr_scale=args.disc_lr_scale,
                       warmup_steps=args.warmup_steps)
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

    def next_batch(step):
        return synthetic_batch(svs_cfg, batch=args.batch_size,
                               t_phones=t_phones, t_frames=t_frames,
                               seed=step)

    gen_state, disc_state = create_states(svs_cfg, tcfg, device)
    start_step = 0
    if args.resume:
        restore_checkpoint(args.resume, gen_state, disc_state)
        # --steps are ADDITIONAL steps: number checkpoints and metrics on
        # from the restored step so a same-dir resume extends the run
        start_step = gen_state.step
        print(f"resumed from {args.resume} at step {start_step}")
    train_step = make_train_step(svs_cfg, tcfg)
    generator = torch.Generator(device).manual_seed(tcfg.seed)
    writer = MetricsWriter(os.path.join(args.ckpt_dir, "logs"))
    ckpt_dir = os.path.abspath(args.ckpt_dir)

    def transfer(b):
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
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"step {start_step + step} ({time.time() - t0:.1f}s): "
                      f"{m}")
                writer.write(start_step + step, metrics)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                save_checkpoint(ckpt_dir, gen_state, disc_state,
                                start_step + step, keep_last=args.keep_last,
                                metric=float(metrics["loss_mel"]))
    finally:
        if feed is not None:  # stop the producer on a consumer error too
            feed.close()
        writer.close()
    save_checkpoint(ckpt_dir, gen_state, disc_state, start_step + args.steps,
                    keep_last=args.keep_last,
                    metric=(float(metrics["loss_mel"])
                            if metrics is not None else None))
    total = time.time() - t0
    print(f"done: {args.steps} steps in {total:.1f}s "
          f"({args.steps * args.batch_size / total:.2f} samples/s)")


if __name__ == "__main__":
    main()
