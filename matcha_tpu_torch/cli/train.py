"""Train Matcha-TTS with the port, on the CUDA card unless `--device` says otherwise.

    python -m matcha_tpu_torch.cli.train [--data-dir data/LJSpeech-1.1 | --synthetic | --tiny]
        [--batch-size 16] [--max-epochs 1000] [--ckpt-dir checkpoints] [--no-resume]
        [--precision fp32|bf16] [--out-size N] [--ckpt-every N]
        [--steps-per-dispatch K] [--mas-impl auto|pallas|ref] [--profile DIR]
        [--tp N] [--device cuda|cpu]

Resumes from the newest checkpoint in `--ckpt-dir` unless `--no-resume`.
Data: an LJSpeech-format directory (`--data-dir`, the default: `metadata.csv`
and `wavs/`; `train.txt` and `val.txt` are written there on first use), the
synthetic dataset (`--synthetic`), or `--tiny`, a reduced-width model on a
small synthetic set. On the card, K = `--steps-per-dispatch` micro-steps run
as one CUDA graph replay.

Several cards: `torchrun --nproc_per_node N -m matcha_tpu_torch.cli.train ...`
trains data-parallel over N ranks, one a card (NCCL), each on its cut of
every global batch of N x `--batch-size`; `--tp M` also shards the Megatron
pairs over M of them (a (N / M, M) mesh; M <= 2 at `MatchaConfig()`, whose
encoder has 2 heads). With `--device cpu` the same runs on gloo ranks.
"""

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train Matcha-TTS (PyTorch/CUDA port)")
    ap.add_argument("--data-dir", default="data/LJSpeech-1.1",
                    help="LJSpeech-format directory (metadata.csv and wavs/)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-epochs", type=int, default=1000)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic dataset (no dataset on disk needed)")
    ap.add_argument("--synthetic-items", type=int, default=256, help="synthetic dataset size")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced-width model and a small synthetic dataset; implies --synthetic")
    ap.add_argument("--mas-impl", default="auto", choices=["auto", "pallas", "ref"],
                    help="the port has one MAS: 'auto' and 'pallas' run the kernel on the "
                         "card and the plain version on the CPU; 'ref' is the CPU's")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="bf16 = mixed precision (bf16 U-Net, f32 master weights)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of dispatches 2-3 into DIR")
    ap.add_argument("--out-size", type=int, default=None,
                    help="train the decoder on a random window of this many frames "
                         "per sample (a multiple of 4)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K micro-steps per dispatch (one CUDA graph replay on the card); "
                         "the trajectory does not depend on K")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N epochs (the last epoch always)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size: ranks of the mesh's model axis (under torchrun)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    from matcha_tpu_torch.parallel import init_distributed, make_mesh, world

    init_distributed(args.device)  # before anything touches the card
    if args.tp > 1 and world() == 1:
        ap.error("--tp > 1 needs several ranks: launch under torchrun")
    mesh = make_mesh(model=args.tp if args.tp > 1 else None) if world() > 1 else None

    from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, TextMelDataset
    from matcha_tpu_torch.data.ljspeech import process_csv
    from matcha_tpu_torch.models.matcha import MatchaConfig, tiny_config
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    if args.tiny:
        model_cfg = tiny_config()
        train_ds = SyntheticDataset(n_items=16, n_mels=model_cfg.n_feats, seed=0,
                                    min_frames=64, max_frames=96)
        val_ds = SyntheticDataset(n_items=8, n_mels=model_cfg.n_feats, seed=1,
                                  min_frames=64, max_frames=96)
        data_cfg = DataConfig(batch_size=args.batch_size, text_pad_multiple=16,
                              mel_pad_multiple=16)
    else:
        model_cfg = MatchaConfig()
        data_cfg = DataConfig(batch_size=args.batch_size)
        if args.synthetic:
            train_ds = SyntheticDataset(n_items=args.synthetic_items, seed=0)
            val_ds = SyntheticDataset(n_items=max(args.synthetic_items // 8, 8), seed=1)
        else:
            data_dir = Path(args.data_dir)
            train_txt, val_txt = data_dir / "train.txt", data_dir / "val.txt"
            if not train_txt.exists() or not val_txt.exists():
                print("generating train/val split from metadata.csv ...")
                process_csv(data_dir, output_dir=data_dir)
            train_ds, val_ds = TextMelDataset(train_txt), TextMelDataset(val_txt)

    trainer = Trainer(
        model_cfg,
        TrainConfig(ckpt_dir=args.ckpt_dir, max_epochs=args.max_epochs,
                    mas_impl=args.mas_impl, precision=args.precision,
                    profile_dir=args.profile, out_size=args.out_size,
                    steps_per_dispatch=args.steps_per_dispatch,
                    ckpt_every_epochs=args.ckpt_every),
        data_cfg, device=args.device, mesh=mesh)
    step = trainer.fit(train_ds, val_ds, max_epochs=args.max_epochs, resume=not args.no_resume)
    print(f"trained to step {step}; checkpoints in {trainer.checkpoints.root}")


if __name__ == "__main__":
    main()
