"""Checkpoint store: top-k on validation loss, plus the latest, with resume.

Each checkpoint is `step_{step:09d}/state.pt` (`torch.save` of a dict holding
the model's and the optimizer's state) under the store's root. `index.json`
lists them with the JAX package's schema, {"entries": [{step, epoch,
val_loss, path}]}, and is replaced atomically. After every save the store
keeps the `keep_top_k` entries of least validation loss and the newest one,
and deletes the others.
"""

import json
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

STATE_FILE = "state.pt"


class CheckpointStore:
    def __init__(self, root, keep_top_k: int = 3):
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_top_k = keep_top_k
        self._index_path = self.root / "index.json"
        self._index = self._load_index()

    def _load_index(self):
        if self._index_path.exists():
            return json.loads(self._index_path.read_text())
        return {"entries": []}

    def _write_index(self):
        tmp = self._index_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self._index, indent=1))
        tmp.replace(self._index_path)

    @property
    def entries(self):
        return list(self._index["entries"])

    def save(self, step: int, epoch: int, state: Any, val_loss: float) -> Path:
        """Write `state` (e.g. {"model": ..., "optimizer": ...}) as checkpoint `step`."""
        path = self.root / f"step_{step:09d}"
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        tmp.replace(path / STATE_FILE)
        self._index["entries"] = [e for e in self._index["entries"] if e["step"] != step]
        self._index["entries"].append(
            {"step": step, "epoch": epoch, "val_loss": float(val_loss), "path": str(path)})
        self._gc()
        self._write_index()
        return path

    def _gc(self):
        """Keep the top-k by validation loss plus the most recent entry."""
        entries = self._index["entries"]
        if not entries:
            return
        latest = max(entries, key=lambda e: e["step"])
        best = sorted(entries, key=lambda e: e["val_loss"])[: self.keep_top_k]
        keep = {e["path"] for e in best} | {latest["path"]}
        for e in entries:
            if e["path"] not in keep and Path(e["path"]).exists():
                shutil.rmtree(e["path"])
        self._index["entries"] = [e for e in entries if e["path"] in keep]

    def latest(self) -> Optional[dict]:
        entries = self._index["entries"]
        return max(entries, key=lambda e: e["step"]) if entries else None

    def best(self) -> Optional[dict]:
        entries = self._index["entries"]
        return min(entries, key=lambda e: e["val_loss"]) if entries else None

    def restore(self, entry: dict, map_location=None) -> Tuple[Any, int, int]:
        """(state, step, epoch) of an index entry."""
        state = torch.load(Path(entry["path"]) / STATE_FILE, map_location=map_location,
                           weights_only=True)
        return state, entry["step"], entry["epoch"]

    def restore_latest(self, map_location=None) -> Optional[Tuple[Any, int, int]]:
        entry = self.latest()
        return None if entry is None else self.restore(entry, map_location)

    def restore_best(self, map_location=None) -> Optional[Tuple[Any, int, int]]:
        entry = self.best()
        return None if entry is None else self.restore(entry, map_location)

    def restore_params(self, prefer: str = "best", map_location=None):
        """The model state dict of the best (or latest) checkpoint, for inference."""
        entry = (self.best() if prefer == "best" else None) or self.latest()
        if entry is None:
            raise FileNotFoundError(f"no checkpoint found in {self.root}")
        return self.restore(entry, map_location)[0]["model"]
