"""Training-run analysis: loss curves and CSVs from the port's metrics stream.

    python -m matcha_tpu_torch.cli.analyze [--log-dir checkpoints/logs] [--out-dir analysis]

The port of `matcha_tpu/cli/analyze.py`, on the host only: it reads the
`metrics.jsonl` that the port's `MetricLogger` writes (the JAX package's
format: one JSON row per log step, with `step`, `epoch` and `train/...` or
`val/...` values), plots per-step and per-epoch duration, prior, diffusion and
total loss curves (`loss_curves.png`, `loss_curves_epoch.png`), and writes
`val_losses.csv`, `all_metrics.csv` and `epoch_losses.csv`. Logs without an
`epoch` column take it from the running count of validation rows, one an
epoch. Needs matplotlib and pandas.
"""

import argparse
import json
from pathlib import Path


def load_metrics(log_dir):
    rows = []
    path = Path(log_dir) / "metrics.jsonl"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found — has training run?")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


LOSSES = ("dur_loss", "prior_loss", "diff_loss", "loss")


def _plot(plt, curves, xlabel, path):
    """2x2 loss curves; `curves(col)` gives the (x, y) of a column, or None."""
    fig, axes = plt.subplots(2, 2, figsize=(14, 8))
    for ax, name in zip(axes.flat, LOSSES):
        for prefix, style in (("train/", "-"), ("val/", "--")):
            xy = curves(prefix + name)
            if xy is not None:
                ax.plot(*xy, style, label=prefix + name)
        ax.set_title(name)
        ax.set_xlabel(xlabel)
        ax.legend()
        ax.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Analyze Matcha-TTS training metrics")
    ap.add_argument("--log-dir", default="checkpoints/logs")
    ap.add_argument("--out-dir", default="analysis")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.DataFrame(load_metrics(args.log_dir))
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def step_curve(col):
        if col not in df.columns:
            return None
        sub = df.dropna(subset=[col])
        return sub["step"], sub[col]

    _plot(plt, step_curve, "step", out / "loss_curves.png")

    val_cols = [c for c in df.columns if c.startswith("val/")]
    if val_cols:
        df.dropna(subset=val_cols[:1])[["step"] + val_cols].to_csv(
            out / "val_losses.csv", index=False)
    df.to_csv(out / "all_metrics.csv", index=False)

    # per-epoch means; a log without an epoch column counts its val rows (one an epoch)
    if "epoch" not in df.columns:
        is_val = df[val_cols[0]].notna() if val_cols else pd.Series(False, index=df.index)
        df["epoch"] = is_val[::-1].cumsum()[::-1]
        df["epoch"] = df["epoch"].max() - df["epoch"]
    loss_cols = [c for c in df.columns if c.split("/")[-1] in LOSSES]
    per_epoch = df.groupby("epoch")[loss_cols].mean()
    per_epoch.to_csv(out / "epoch_losses.csv")

    def epoch_curve(col):
        if col not in per_epoch.columns:
            return None
        sub = per_epoch[col].dropna()
        return sub.index, sub.values

    _plot(plt, epoch_curve, "epoch", out / "loss_curves_epoch.png")
    print(f"wrote {out}/loss_curves.png, loss_curves_epoch.png and CSVs "
          f"({len(df)} rows, {len(per_epoch)} epochs)")


if __name__ == "__main__":
    main()
