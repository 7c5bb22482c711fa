"""Profiling and performance counters (port of ``eradiate_tpu/profiling.py``).

- :func:`trace`: a ``torch.profiler`` window (the CPU and, with a card, the
  CUDA activities) written as a Chrome trace into a directory;
- :func:`annotate`: a named range on the profiler's timeline (and an NVTX
  range on a card), so that the experiment's phases show in a trace;
- :class:`RenderStats` and the global :data:`stats`: wall time, path counts
  and samples/s of every render, queryable after a run
  (``eradiate_tpu_torch.profiling.stats.last``, ``.summary()``);
- :func:`kernel_roofline`: a kernel's achieved rates against the H100's
  published peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["trace", "annotate", "RenderRecord", "RenderStats", "stats", "timed_render",
           "H100_PEAKS", "kernel_roofline"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write the window as
    ``trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline; on a card also an NVTX
    range, which device-side tools show."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@dataclasses.dataclass
class RenderRecord:
    label: str
    wall_s: float
    n_paths: int
    spectral_size: int
    n_pixels: int
    spp: int

    @property
    def samples_per_s(self) -> float:
        return self.n_paths / self.wall_s if self.wall_s > 0 else 0.0


class RenderStats:
    """Accumulates per-render statistics."""

    def __init__(self):
        self.records: list[RenderRecord] = []

    def record(self, label, wall_s, spectral_size, n_pixels, spp):
        rec = RenderRecord(
            label=label,
            wall_s=wall_s,
            n_paths=int(spectral_size) * int(n_pixels) * int(spp),
            spectral_size=int(spectral_size),
            n_pixels=int(n_pixels),
            spp=int(spp),
        )
        self.records.append(rec)
        return rec

    @property
    def last(self) -> RenderRecord | None:
        return self.records[-1] if self.records else None

    def summary(self) -> dict:
        """Aggregate counters: total paths, wall time, mean samples/s."""
        if not self.records:
            return {"n_renders": 0, "total_paths": 0, "total_wall_s": 0.0,
                    "samples_per_s": 0.0}
        total_paths = sum(r.n_paths for r in self.records)
        total_wall = sum(r.wall_s for r in self.records)
        return {
            "n_renders": len(self.records),
            "total_paths": total_paths,
            "total_wall_s": total_wall,
            "samples_per_s": total_paths / total_wall if total_wall > 0 else 0.0,
        }

    def clear(self):
        self.records.clear()


#: global recorder fed by the experiments
stats = RenderStats()


def _synchronize(out):
    """Wait for the card to finish the work behind ``out``'s CUDA tensors."""
    devices = {v.device for v in (out.values() if isinstance(out, dict) else [out])
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


def timed_render(label, fn, *, spectral_size, n_pixels, spp):
    """Run ``fn()`` (a render returning a dict of tensors, or a tensor), wait
    for its device, and record wall time and samples/s under ``label``."""
    t0 = time.perf_counter()
    out = fn()
    _synchronize(out)
    wall = time.perf_counter() - t0
    stats.record(label, wall, spectral_size, n_pixels, spp)
    return out


# ---------------------------------------------------------------------------
# Roofline accounting

#: Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
#: 700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 and 34 in
#: float64 outside the tensor cores. A card set to a lower power limit runs
#: below them.
H100_PEAKS = {
    "card": "NVIDIA H100 SXM (80 GB HBM3), 700 W",
    "hbm_bytes_per_s": 3.35e12,
    "f32_flop_per_s": 67e12,
    "f64_flop_per_s": 34e12,
}


def kernel_roofline(label, wall_s, flops, bytes_moved, unit="f32"):
    """Achieved-against-peak accounting for one kernel invocation on the
    H100 (:data:`H100_PEAKS`).

    ``flops``: the operations the invocation needs; ``bytes_moved``: the
    bytes it must move (each input read once, each output written once);
    ``unit``: ``"f32"`` or ``"f64"``, the rate the operations run at.
    Returns the achieved rates, the fractions of peak, the arithmetic
    intensity and the bound resource (whichever fraction is higher).
    """
    peak_flops = H100_PEAKS[f"{unit}_flop_per_s"]
    peak_bw = H100_PEAKS["hbm_bytes_per_s"]
    achieved_flops = flops / wall_s if wall_s > 0 else 0.0
    achieved_bw = bytes_moved / wall_s if wall_s > 0 else 0.0
    frac_compute = achieved_flops / peak_flops
    frac_bw = achieved_bw / peak_bw
    return {
        "label": label,
        "card": H100_PEAKS["card"],
        "wall_s": wall_s,
        "gflop_per_s": achieved_flops / 1e9,
        "gbytes_per_s": achieved_bw / 1e9,
        "frac_compute_peak": frac_compute,
        "frac_hbm_peak": frac_bw,
        "intensity_flop_per_byte": (
            flops / bytes_moved if bytes_moved else float("inf")
        ),
        "ridge_flop_per_byte": peak_flops / peak_bw,
        "bound": "compute" if frac_compute >= frac_bw else "hbm",
        "speed_of_light_frac": max(frac_compute, frac_bw),
    }
