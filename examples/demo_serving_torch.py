"""Batched serving demo on the PyTorch/CUDA port's `TTSEngine`.

The port's counterpart of `demo_serving.ipynb`. On the card every stage of
a request (encode; decode, vocode and pack; or the one-graph low-latency
path) replays a CUDA graph captured at a fixed (batch, text bucket, mel
budget) shape, so the host issues a few graph launches a request:

  1. `warmup` captures the graphs of the batch sizes and the text bucket to
     be served;
  2. `synthesise` serves a batch of texts, decoded at the smallest budget
     that fits the longest;
  3. `synthesise_lowlatency` serves one text through one graph at a fixed
     budget, with no host read before its copy to the host;
  4. `serve()` takes concurrent requests, each from its own thread, which the
     batching worker groups (at most `max_batch`) and decodes per budget.

Prints each request's budget, mel lengths and real-time factor, and writes
`batch_<i>.wav`, `lowlatency.wav` and `serve_<i>.wav`. Weights are random,
from `--seed`, unless a checkpoint is given in the reference's formats
(`--torch-ckpt matcha_final.ckpt`, `--hifigan-ckpt generator_v1`) or as a
store the port's trainers wrote (`--ckpt-dir`, `--vocoder-ckpt-dir`). Runs on
the CUDA card unless `--device cpu` (where each stage runs eagerly);
`--tiny` takes a reduced-width model (the notebooks' `MATCHA_DEMO_TINY`).

    python examples/demo_serving_torch.py [--vocoder hifigan|griffin_lim] [--bf16]
        [--steps 10] [--out served_demo] [--torch-ckpt matcha_final.ckpt]
        [--hifigan-ckpt generator_v1] [--seed 0] [--device cpu] [--tiny]
"""

import argparse
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))  # demo_torch, beside this file

import demo_torch  # noqa: E402  (puts the repository's package on the path)

TEXTS = ["Flow matching makes text to speech fast.",
         "Hello there, this is a second utterance.",
         "The birch canoe slid on the smooth planks.",
         "Glue the sheet to the dark blue background."]
LOWLATENCY_TEXT = "One sentence, served through a single graph."


def serve_concurrently(engine, texts, seeds):
    """Each (text, seed) as its own `serve()` call from its own thread; the
    (waveform, info) pairs in order."""
    results = [None] * len(texts)

    def request(i):
        results[i] = engine.serve(texts[i], seeds[i])

    engine.start_batching(max_wait_ms=50.0)  # long enough for the threads to form one group
    try:
        threads = [threading.Thread(target=request, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        engine.stop_batching()
    if any(r is None for r in results):
        raise RuntimeError("a serve() request did not complete")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="TTSEngine serving demo (PyTorch/CUDA port)")
    ap.add_argument("--vocoder", default="hifigan", choices=["hifigan", "griffin_lim"])
    ap.add_argument("--bf16", action="store_true", help="bf16 serving precision")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="served_demo")
    ap.add_argument("--torch-ckpt", default=None,
                    help="the reference's Lightning checkpoint (matcha_final.ckpt)")
    ap.add_argument("--ckpt-dir", default=None, help="a store written by the port's trainer")
    ap.add_argument("--hifigan-ckpt", default=None, help="the reference's generator_v1")
    ap.add_argument("--vocoder-ckpt-dir", default=None,
                    help="a store written by the port's vocoder trainer")
    ap.add_argument("--seed", type=int, default=0, help="random weights and request seeds")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--tiny", action="store_true", help="reduced widths, for tests")
    args = ap.parse_args(argv)

    from matcha_tpu_torch import resolve_device
    from matcha_tpu_torch.serve import ServeConfig, TTSEngine
    from matcha_tpu_torch.utils import save_wav

    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    mcfg, hcfg, mel_cfg = demo_torch.configs(args.tiny)
    model, vocoder = demo_torch.load_models(args, mcfg, hcfg)
    budgets = {"mel_budgets": (64, 128)} if args.tiny else {}
    cfg = ServeConfig(n_timesteps=args.steps, bf16=args.bf16, vocoder=args.vocoder,
                      mel_cfg=mel_cfg, **budgets)
    engine = TTSEngine(model.state_dict(), mcfg, cfg,
                       vocoder.state_dict() if args.vocoder == "hifigan" else None, hcfg,
                       device=device, seed=args.seed)

    longest = max(TEXTS + [LOWLATENCY_TEXT], key=len)  # one text bucket for every request
    engine.warmup(batch_sizes=(1, len(TEXTS)), text=longest)
    print(f"{len(engine._stages)} stages ready on {device}")

    seeds = [args.seed + i for i in range(len(TEXTS))]
    wavs, info = engine.synthesise(TEXTS, seeds=seeds)
    print(f"batch of {len(TEXTS)}: budget {info['budget']}, mel lengths {info['mel_lengths']}, "
          f"RTF {info['rtf']:.4f}")
    wav_ll, info_ll = engine.synthesise_lowlatency(LOWLATENCY_TEXT, seed=args.seed)
    print(f"low-latency: budget {info_ll['budget']}, {info_ll['mel_lengths'][0]} mel frames, "
          f"{1e3 * info_ll['wall_s']:.1f} ms, RTF {info_ll['rtf']:.4f}")
    served = serve_concurrently(engine, TEXTS, seeds)
    for i, (_, inf) in enumerate(served):
        print(f"serve() request {i}: group of {inf['group_size']}, budget {inf['budget']}, "
              f"{inf['mel_length']} mel frames, latency {1e3 * inf['latency_s']:.1f} ms")

    sr = mel_cfg.sample_rate
    for i, wav in enumerate(wavs):
        save_wav(out / f"batch_{i}.wav", wav, sr)
    save_wav(out / "lowlatency.wav", wav_ll, sr)
    for i, (wav, _) in enumerate(served):
        save_wav(out / f"serve_{i}.wav", wav, sr)
    print(f"wrote {len(wavs)} batch, 1 low-latency and {len(served)} serve() wavs to {out}")
    return {"engine": engine, "params": model.state_dict(),
            "vocoder_params": vocoder.state_dict(), "seeds": seeds, "batch": (wavs, info),
            "lowlatency": (wav_ll, info_ll), "served": served}


if __name__ == "__main__":
    main()
