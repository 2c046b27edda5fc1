"""Train the HiFi-GAN v1 vocoder with the port, on the CUDA card unless `--device` says otherwise.

    python -m matcha_tpu_torch.cli.train_vocoder --data train.txt       # wav|text metadata
    python -m matcha_tpu_torch.cli.train_vocoder --data path/to/wavs_dir
    python -m matcha_tpu_torch.cli.train_vocoder --synthetic --epochs 2
        [--val-data V] [--tiny] [--batch-size 16] [--segment-size 8192]
        [--ckpt-dir checkpoints_vocoder] [--no-resume] [--steps-per-dispatch K]
        [--ckpt-every N] [--device cuda|cpu]

Resumes from the newest checkpoint in `--ckpt-dir` unless `--no-resume`. On
the card, K = `--steps-per-dispatch` GAN steps run as one CUDA graph replay.
`--tiny`: a reduced generator and discriminators on 8 synthetic items.
`load_generator_for_inference(ckpt_dir)` (`train/vocoder.py`) folds a
trained generator for `TTSEngine(vocoder_params=...)`.

Several cards: `torchrun --nproc_per_node N -m matcha_tpu_torch.cli.train_vocoder
...` trains data-parallel over N ranks (NCCL; gloo with `--device cpu`), a
global batch of N x `--batch-size` segments a step.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the HiFi-GAN v1 vocoder (PyTorch/CUDA port)")
    ap.add_argument("--data", help="metadata file (wav|text lines) or directory of wavs")
    ap.add_argument("--val-data", help="optional validation metadata file or directory")
    ap.add_argument("--synthetic", action="store_true", help="synthetic waveforms")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--segment-size", type=int, default=8192)
    ap.add_argument("--ckpt-dir", default="checkpoints_vocoder")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K GAN steps per dispatch (one CUDA graph replay on the card); "
                         "the trajectory does not depend on K")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N epochs (the last epoch always)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny generator and discriminators on 8 synthetic items")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from matcha_tpu_torch.parallel import init_distributed, make_mesh, world

    init_distributed(args.device)  # before anything touches the card
    mesh = make_mesh(model=None) if world() > 1 else None

    from matcha_tpu_torch.data.audio_dataset import (
        AudioDataConfig,
        SyntheticWavDataset,
        WavSegmentDataset,
    )
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.train.vocoder import Discriminators, VocoderTrainConfig, VocoderTrainer

    if args.tiny:
        train_ds = SyntheticWavDataset(n_items=8, segment_size=args.segment_size)
        val_ds = SyntheticWavDataset(n_items=4, segment_size=args.segment_size, seed=1)
    elif args.synthetic:
        train_ds = SyntheticWavDataset(n_items=64, segment_size=args.segment_size)
        val_ds = SyntheticWavDataset(n_items=8, segment_size=args.segment_size, seed=1)
    elif args.data:
        train_ds = WavSegmentDataset(args.data, args.segment_size)
        val_ds = WavSegmentDataset(args.val_data, args.segment_size) if args.val_data else None
    else:
        ap.error("provide --data or --synthetic")

    kwargs = {}
    if args.tiny:
        kwargs = dict(
            gen_cfg=HiFiGANConfig(upsample_initial_channel=16),
            disc=Discriminators(
                mpd_channels=(4, 8),
                msd_spec=((8, 15, 1, 1, 7), (8, 41, 4, 4, 20), (8, 5, 1, 1, 2)),
            ),
        )
    trainer = VocoderTrainer(
        train_cfg=VocoderTrainConfig(max_epochs=args.epochs, ckpt_dir=args.ckpt_dir,
                                     steps_per_dispatch=args.steps_per_dispatch,
                                     ckpt_every_epochs=args.ckpt_every),
        data_cfg=AudioDataConfig(batch_size=args.batch_size, segment_size=args.segment_size),
        device=args.device, mesh=mesh, **kwargs)
    step = trainer.fit(train_ds, val_ds, max_epochs=args.epochs, resume=not args.no_resume)
    print(f"trained to step {step}; checkpoints in {trainer.checkpoints.root}")


if __name__ == "__main__":
    main()
