"""Batched serving CLI on top of the port's `TTSEngine`.

    python -m matcha_tpu_torch.cli.serve --texts "First sentence." "Second sentence."
        [--ckpt-dir checkpoints | --torch-ckpt matcha_final.ckpt]
        [--vocoder hifigan --hifigan-ckpt generator_v1 | --vocoder-ckpt-dir DIR]
        [--steps 10] [--bf16] [--int16] [--mel-budgets 128 256 512 1024]
        [--concurrent | --low-latency] [--out-dir served_audio] [--seed 0]
        [--device cuda|cpu]

The port of `matcha_tpu/cli/serve.py`, on the CUDA card unless `--device`
says otherwise. Synthesises the texts as one batch (`synthesise`), or each
through the one-graph low-latency path (`--low-latency`), or each as its own
`serve()` request from its own thread through the batching worker
(`--concurrent`). On the card every stage replays the engine's CUDA graphs.
Writes `utt_<i>.wav` for each text.
"""

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batched Matcha-TTS serving (PyTorch/CUDA port)")
    ap.add_argument("--texts", nargs="+", required=True)
    ap.add_argument("--ckpt-dir", default="checkpoints",
                    help="checkpoint directory written by the port's trainer (the JAX "
                         "package's Orbax stores cannot be read: pass --torch-ckpt)")
    ap.add_argument("--torch-ckpt", default=None,
                    help="the reference's Lightning checkpoint (matcha_final.ckpt)")
    ap.add_argument("--vocoder", default="griffin_lim", choices=["griffin_lim", "hifigan"])
    ap.add_argument("--vocoder-ckpt-dir", default=None)
    ap.add_argument("--hifigan-ckpt", default=None, help="torch generator_v1 ckpt")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--bf16", action="store_true", help="bf16 serving precision")
    ap.add_argument("--out-dir", default="served_audio")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--concurrent", action="store_true",
                    help="drive each text as a separate serve() request from its "
                         "own thread through the batching front-end (max-wait "
                         "batching, per-request seeds) instead of one synthesise "
                         "batch")
    ap.add_argument("--low-latency", action="store_true",
                    help="synthesise each text through the one-graph fused path "
                         "(synthesise_lowlatency): fixed largest budget, no host "
                         "budget-pick round trip")
    ap.add_argument("--int16", action="store_true",
                    help="device-side PCM16 waveforms (half the device->host "
                         "traffic of float32; what the output wav file stores anyway)")
    ap.add_argument("--mel-budgets", type=int, nargs="+", default=None,
                    help="static mel-frame budgets (default 128 256 512 1024). "
                         "A single budget makes the batching worker zero-sync: no "
                         "predicted-length host read per group")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    if args.vocoder == "hifigan" and not (args.hifigan_ckpt or args.vocoder_ckpt_dir):
        raise SystemExit("hifigan vocoder needs --hifigan-ckpt or --vocoder-ckpt-dir")

    from matcha_tpu_torch import resolve_device
    from matcha_tpu_torch.cli.generate import load_params, load_vocoder
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine
    from matcha_tpu_torch.utils import save_wav

    device = resolve_device(args.device)  # raises before any file is read without a card
    params = load_params(args)
    vocoder_params = (load_vocoder(args.hifigan_ckpt, args.vocoder_ckpt_dir).state_dict()
                      if args.vocoder == "hifigan" else None)

    engine = TTSEngine(
        params,
        cfg=ServeConfig(n_timesteps=args.steps, bf16=args.bf16, vocoder=args.vocoder,
                        max_batch=max(len(args.texts), 16),
                        output_dtype="int16" if args.int16 else "float32",
                        **({"mel_budgets": tuple(args.mel_budgets)}
                           if args.mel_budgets else {})),
        vocoder_params=vocoder_params, device=device)
    if args.low_latency:
        wavs, infos = [], []
        for i, text in enumerate(args.texts):
            wav, inf = engine.synthesise_lowlatency(text, seed=args.seed + i)
            wavs.append(wav)
            infos.append(inf)
            print(f"low-latency: {inf['wall_s'] * 1e3:.1f} ms, "
                  f"budget={inf['budget']}, rtf={inf['rtf']:.4f}")
        info = {"budget": max(i["budget"] for i in infos),
                "wall_s": max(i["wall_s"] for i in infos),
                "rtf": sum(i["rtf"] for i in infos) / len(infos)}
    elif args.concurrent:
        import threading

        engine.start_batching()
        results = [None] * len(args.texts)
        errors = []

        def run(i):
            try:
                results[i] = engine.serve(args.texts[i], seed=args.seed + i)
            except Exception as e:  # surface the real error after join, not a
                errors.append((i, e))  # TypeError from the None placeholder

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(args.texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        engine.stop_batching()
        if errors:
            i, e = errors[0]
            raise RuntimeError(f"serve() failed for text {i}: {e}") from e
        wavs = [w for w, _ in results]
        infos = [inf for _, inf in results]
        info = {"budget": max(i["budget"] for i in infos),
                "wall_s": max(i["wall_s"] for i in infos),
                "rtf": sum(i["rtf"] for i in infos) / len(infos)}
        print(f"concurrent: group sizes {[i['group_size'] for i in infos]}")
    else:
        wavs, info = engine.synthesise(args.texts, seed=args.seed)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, wav in enumerate(wavs):
        path = out / f"utt_{i:03d}.wav"
        save_wav(path, wav, engine.cfg.mel_cfg.sample_rate)
        print(f"saved {path} ({wav.shape[0] / engine.cfg.mel_cfg.sample_rate:.2f} s)")
    print(f"batch of {len(wavs)}: budget={info['budget']} frames, "
          f"wall={info['wall_s']:.3f} s, rtf={info['rtf']:.4f}")


if __name__ == "__main__":
    main()
