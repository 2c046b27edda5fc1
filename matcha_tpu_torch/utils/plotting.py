"""Spectrogram and alignment images for logs and CLI output.

The port of `matcha_tpu/utils/plotting.py`: render a (C, T) array to an RGB
image for TensorBoard, or save a dB-scaled mel PNG. matplotlib is imported
when a function runs, never with the module; figures render off-screen and
no global backend switch is made.
"""

import numpy as np


def _numpy(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):  # a torch tensor
        tensor = tensor.detach().float().cpu().numpy()
    return np.asarray(tensor)


def plot_tensor(tensor) -> np.ndarray:
    """(C, T) array -> (H, W, 3) uint8 RGB image for TensorBoard."""
    import matplotlib.pyplot as plt

    arr = _numpy(tensor)
    if arr.ndim == 3:
        arr = arr[0]
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(arr, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.tight_layout()
    fig.canvas.draw()
    buf = fig.canvas.buffer_rgba()
    w, h = fig.canvas.get_width_height()
    data = np.frombuffer(buf, dtype=np.uint8).reshape(h, w, 4)[:, :, :3].copy()
    plt.close(fig)
    return data


def plot_spectrogram(spectrogram):
    """(C, T) array -> matplotlib Figure; the caller closes it (`plt.close(fig)`)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(_numpy(spectrogram), aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    return fig


def save_mel_png(log_mel, path, title="Mel Spectrogram"):
    """Save a dB-scaled image of a (n_mels, T) log-mel (or linear mel) to `path`."""
    import matplotlib.pyplot as plt

    data = _numpy(log_mel)
    if data.ndim == 3:
        data = data[0]
    if data.min() < 0:  # log-mel -> linear
        data = np.exp(data)
    db = 20 * np.log10(data + 1e-10)
    vmin, vmax = np.percentile(db, 1), np.percentile(db, 99)
    if vmax < -10:
        vmax = db.max()
    plt.figure(figsize=(12, 6))
    img = plt.imshow(db, origin="lower", aspect="auto", cmap="viridis",
                     vmin=vmin, vmax=vmax, interpolation="bilinear")
    plt.title(title)
    plt.xlabel("Time (frames)")
    plt.ylabel("Mel bins")
    plt.colorbar(img, label="dB")
    plt.tight_layout()
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
