"""Command-line interface of the port (counterpart of ``eradiate_tpu/cli.py``).

The same argparse tree, subcommands and flags as the JAX package's CLI
(``sys-info``, ``data ...``, ``srf trim``, ``render``). Run as::

    python -m eradiate_tpu_torch.cli <command>

``render`` runs on the card unless ``--platform cpu`` asks for the CPU;
without a card it exits non-zero and never renders on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _devices():
    import torch

    out = ["cpu"]
    if torch.cuda.is_available():
        out += [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                for i in range(torch.cuda.device_count())]
    return out


def cmd_sys_info(args):
    """Environment diagnostics (mirror of ``cli/sys_info.py``): the port's
    version and the torch, CUDA and numpy versions, the devices torch sees
    and the entry points' default device."""
    import platform

    import numpy
    import torch

    info = {
        "eradiate_tpu_torch": __import__("eradiate_tpu_torch").__version__,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "devices": _devices(),
        "default_device": "cuda",
        "cuda_available": torch.cuda.is_available(),
    }
    print(json.dumps(info, indent=2))


def cmd_data_paths(args):
    from .data import data_paths

    for p in data_paths():
        exists = "present" if p.exists() else "absent"
        print(f"{p}  [{exists}]")


def cmd_data_list(args):
    from .data import data_paths

    for base in data_paths():
        if not base.exists():
            continue
        for f in sorted(base.rglob("*.npz")):
            print(f.relative_to(base))


def cmd_data_install(args):
    """Install a dataset archive/directory into the user data dir (offline
    analog of ``eradiate data install``, ``cli/data.py:29-124``)."""
    from .data.asset_manager import install

    dest = install(args.source, name=args.name, sha256=args.sha256)
    print(f"installed -> {dest}")
    return 0


def cmd_data_remove(args):
    from .data.asset_manager import remove

    if remove(args.name):
        print(f"removed {args.name}")
        return 0
    print(f"no installed asset named {args.name!r}", file=sys.stderr)
    return 1


def cmd_data_installed(args):
    from .data.asset_manager import list_installed

    for name, entry in sorted(list_installed().items()):
        print(f"{name}\t{entry['path']}")
    return 0


def cmd_data_validate(args):
    from .data.validation import DatasetSchemaError, validate_dataset
    from .xr import Dataset

    if not str(args.path).endswith(".npz"):
        print(
            "validate supports the native .npz dataset format (import "
            "NetCDF data first; see eradiate_tpu_torch.data.netcdf)",
            file=sys.stderr,
        )
        return 1
    ds = Dataset.from_npz(args.path)
    try:
        validate_dataset(ds, args.schema)
    except DatasetSchemaError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"{args.path}: valid ({args.schema})")
    return 0


def cmd_srf_trim(args):
    """Trim an SRF dataset (mirror of ``eradiate srf trim``,
    ``cli/srf.py:27``)."""
    import numpy as np

    from .srf_tools import trim_srf

    d = np.load(args.input)
    w, srf = trim_srf(d["w"], d["srf"], threshold=args.threshold, keep_integral=args.keep)
    np.savez(args.output, w=w, srf=srf)
    print(f"trimmed {d['w'].size} -> {w.size} points -> {args.output}")


def cmd_render(args):
    """Render a JSON experiment config end to end.

    A multi-process launch needs no user code: :func:`.parallel.initialize`
    reads the ``ERADIATE_TPU_COORDINATOR`` / ``ERADIATE_TPU_NUM_PROCESSES``
    / ``ERADIATE_TPU_PROCESS_ID`` variables (or torchrun's) before anything
    else touches CUDA, and ``--mesh auto`` shards the render over every
    rank::

        ERADIATE_TPU_COORDINATOR=host0:1234 ERADIATE_TPU_NUM_PROCESSES=2 \\
            ERADIATE_TPU_PROCESS_ID=0 \\
            python -m eradiate_tpu_torch.cli render scene.json --mesh auto

    Rank 0 alone writes or prints the result, then a line with the
    render's wall time and the kernels it launched.
    """
    if args.cpu_devices is not None and args.cpu_devices != 1:
        print(
            f"render: --cpu-devices {args.cpu_devices} has no counterpart in torch (it sets "
            "XLA's virtual CPU devices); run one process a rank instead, with torchrun or "
            "the ERADIATE_TPU_COORDINATOR, ERADIATE_TPU_NUM_PROCESSES and "
            "ERADIATE_TPU_PROCESS_ID variables",
            file=sys.stderr,
        )
        return 2
    import torch

    device = "cpu" if args.platform == "cpu" else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print(
            "render: no CUDA device (torch.cuda.is_available() is False); pass "
            "--platform cpu to render on the CPU",
            file=sys.stderr,
        )
        return 1

    from .parallel import initialize

    multi = initialize(device=device)

    import torch.distributed as dist

    import eradiate_tpu_torch
    from .experiments import AtmosphereExperiment, CanopyAtmosphereExperiment
    from .kernels import read_launches, reset_launches

    with open(args.config) as f:
        cfg = json.load(f)
    eradiate_tpu_torch.set_mode(cfg.pop("mode", "mono"))
    cls = CanopyAtmosphereExperiment if "canopy" in cfg else AtmosphereExperiment
    exp = cls(**cfg)
    mesh = {"auto": "auto", "none": None}[args.mesh]
    reset_launches()
    t0 = time.perf_counter()
    result = eradiate_tpu_torch.run(exp, mesh=mesh, device=device)
    wall = time.perf_counter() - t0
    if multi and dist.get_rank() != 0:
        return 0  # only rank 0 writes/prints results
    if args.output:
        result.to_npz(args.output)
        print(f"results -> {args.output}")
    else:
        print(result)
    launches = {k: n for k, n in read_launches().items() if n}
    print(f"render: {wall:.3f} s on {device}; kernel launches {json.dumps(launches)}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="eradiate_tpu_torch", description="GPU radiative transfer CLI (PyTorch/CUDA)"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("sys-info", help="show environment info").set_defaults(fn=cmd_sys_info)

    data = sub.add_parser("data", help="data store management")
    data_sub = data.add_subparsers(dest="data_command", required=True)
    data_sub.add_parser("paths", help="show search paths").set_defaults(fn=cmd_data_paths)
    data_sub.add_parser("list", help="list installed datasets").set_defaults(fn=cmd_data_list)
    validate = data_sub.add_parser("validate", help="validate a dataset file against a schema")
    validate.add_argument("path")
    validate.add_argument(
        "--schema", default="srf_v1", help="schema name (srf_v1, particle_dataset_v1)",
    )
    validate.set_defaults(fn=cmd_data_validate)
    inst = data_sub.add_parser("install", help="install a local dataset archive or directory")
    inst.add_argument("source", help="path to .zip/.tar[.gz] archive, "
                      "directory, or single data file")
    inst.add_argument("--name", default=None, help="install name")
    inst.add_argument("--sha256", default=None, help="expected checksum")
    inst.set_defaults(fn=cmd_data_install)
    rm = data_sub.add_parser("remove", help="remove an installed asset")
    rm.add_argument("name")
    rm.set_defaults(fn=cmd_data_remove)
    data_sub.add_parser(
        "installed", help="list assets installed via 'data install'"
    ).set_defaults(fn=cmd_data_installed)

    srf = sub.add_parser("srf", help="SRF tools")
    srf_sub = srf.add_subparsers(dest="srf_command", required=True)
    trim = srf_sub.add_parser("trim", help="trim an SRF dataset")
    trim.add_argument("input")
    trim.add_argument("output")
    trim.add_argument("--threshold", type=float, default=1e-3)
    trim.add_argument("--keep", type=float, default=None)
    trim.set_defaults(fn=cmd_srf_trim)

    render = sub.add_parser("render", help="run an experiment from JSON config")
    render.add_argument("config")
    render.add_argument("-o", "--output", default=None)
    render.add_argument(
        "--mesh", choices=["auto", "none"], default="auto",
        help="'auto' = shard over every rank of the process group (started from "
        "ERADIATE_TPU_COORDINATOR et al. or torchrun's variables), 'none' = one device",
    )
    render.add_argument(
        "--platform", choices=["default", "cpu"], default="default",
        help="'default' renders on the card (and fails without one), 'cpu' on the CPU",
    )
    render.add_argument(
        "--cpu-devices", type=int, default=None,
        help="accepted for 1 only: torch has no virtual CPU devices (start one "
        "process a rank instead)",
    )
    render.set_defaults(fn=cmd_render)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
