"""Start ``torch.distributed`` for a sharded run (port of
``eradiate_tpu/parallel/multihost.py``).

One process per rank. Every process calls :func:`initialize` once at
program start, then builds the same ("spectral", "sample") mesh
(:func:`.render.make_render_mesh`) and calls the same sharded renders with
the same host-side scene::

    import eradiate_tpu_torch.parallel as p
    p.initialize()                                   # torchrun's variables
    mesh = p.make_render_mesh(n_spectral, n_sample)  # over every rank
    result = p.render_sharded(scene, sensor, config, spp, mesh=mesh)

``torchrun --nproc-per-node=N script.py`` sets the variables it reads. A
launcher of its own passes them (or the arguments) itself.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["initialize"]


def _env_int(*names):
    for name in names:
        if os.environ.get(name) is not None:
            return int(os.environ[name])
    return None


def _init_method(coordinator_address):
    """A ``host:port`` address as a TCP rendezvous; an address with a
    scheme (``tcp://``, ``file://``) as it is."""
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address=None, num_processes=None, process_id=None, backend=None,
               device=None) -> bool:
    """Start the default process group for a multi-process run; return
    whether the world has more than one rank.

    The arguments default to ``ERADIATE_TPU_COORDINATOR`` (``host:port``,
    or a ``tcp://``/``file://`` address), ``ERADIATE_TPU_NUM_PROCESSES`` and
    ``ERADIATE_TPU_PROCESS_ID``, then to torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. With none of them the run
    is single-process and nothing starts.

    ``device`` is ``"cuda"`` by default (raising without a card, as every
    entry point) or ``"cpu"``; ``backend`` is ``"nccl"`` for CUDA and
    ``"gloo"`` for the CPU unless named. On CUDA the process takes card
    ``LOCAL_RANK`` (else its process id) and raises when there is no such
    card, rather than share one; an explicit ``"cuda:<index>"`` takes that
    card. A second call, or a call after the caller started the group,
    changes nothing.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1

    if coordinator_address is None:
        coordinator_address = os.environ.get("ERADIATE_TPU_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR") is not None:
        # torchrun's store (its agent's, where it hosts one), as torch reads it
        coordinator_address = "env://"
    if num_processes is None:
        num_processes = _env_int("ERADIATE_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("ERADIATE_TPU_PROCESS_ID", "RANK")
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the number of processes "
            "and this process's id (ERADIATE_TPU_NUM_PROCESSES/WORLD_SIZE, "
            "ERADIATE_TPU_PROCESS_ID/RANK)"
        )

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)  # raises without a card
        index = dev.index
        if index is None:
            index = _env_int("LOCAL_RANK")
            index = process_id if index is None else index
            if index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {index} has no card of its own "
                    f"({torch.cuda.device_count()} visible); start at most one rank a card"
                )
        torch.cuda.set_device(index)
    else:
        resolve_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address), world_size=int(num_processes),
        rank=int(process_id),
    )
    logger.info("process group up: rank %d of %d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return dist.get_world_size() > 1
