# Host-code copy of eradiate_tpu/checkpoint.py; regenerate with tools/copy_host_code.py, do not edit.
"""Checkpoint/resume for long spectral renders.

SURVEY §5: the reference has no mid-render checkpointing (granularity is
the experiment; ``experiments/_core.py:845-850``) and spectral-bin
accumulator checkpointing is the natural TPU-build equivalent. This module
persists per-measure raw accumulators after every spectral chunk, so a
killed 300k-wavelength mono sweep resumes at the last completed chunk.

Format: one ``<measure_id>.npz`` per measure inside the checkpoint
directory, holding every raw output array per completed chunk plus a
fingerprint (measure id, spp, spectral-grid hash) that guards against
resuming into a different run configuration. Seed-state determinism is the
caller's job: skipped chunks must still consume their seeds
(``Experiment.process`` does this).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ["RenderCheckpoint"]


def _fingerprint(measure_id: str, spp: int, w) -> str:
    h = hashlib.sha256()
    h.update(str(measure_id).encode())
    h.update(str(int(spp)).encode())
    h.update(np.ascontiguousarray(np.asarray(w, dtype=np.float64)).tobytes())
    return h.hexdigest()[:32]


class RenderCheckpoint:
    """Per-measure chunk-granular checkpoint store."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, measure_id: str) -> str:
        safe = str(measure_id).replace(os.sep, "_")
        return os.path.join(self.directory, f"{safe}.npz")

    def load(self, measure_id: str, spp: int, w):
        """Return (completed_raws: list[dict], n_chunks_done). Empty when
        absent or when the fingerprint does not match the current run."""
        path = self._path(measure_id)
        if not os.path.exists(path):
            return [], 0
        with np.load(path, allow_pickle=False) as z:
            meta_fp = str(z["fingerprint"])
            if meta_fp != _fingerprint(measure_id, spp, w):
                return [], 0
            n_done = int(z["n_chunks_done"])
            keys = [str(k) for k in z["raw_keys"]]
            raws = []
            for i in range(n_done):
                raw = {}
                for k in keys:
                    arr = z[f"chunk{i}_{k}"]
                    raw[k] = arr if arr.ndim else arr.item()
                raws.append(raw)
            return raws, n_done

    def save(self, measure_id: str, spp: int, w, raws):
        """Persist the raw outputs of every completed chunk (atomic
        replace)."""
        path = self._path(measure_id)
        payload = {
            "fingerprint": _fingerprint(measure_id, spp, w),
            "n_chunks_done": np.asarray(len(raws)),
        }
        keys = sorted(raws[0].keys()) if raws else []
        payload["raw_keys"] = np.asarray(keys)
        for i, raw in enumerate(raws):
            for k in keys:
                payload[f"chunk{i}_{k}"] = np.asarray(raw[k])
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    def clear(self, measure_id: str):
        path = self._path(measure_id)
        if os.path.exists(path):
            os.remove(path)
