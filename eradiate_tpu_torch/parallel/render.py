"""Sharded renders, one for each tracer family (port of
``eradiate_tpu/parallel/render.py``).

A ("spectral", "sample") :class:`~torch.distributed.device_mesh.DeviceMesh`
of ``torch.distributed`` ranks, one process a rank, each holding the whole
scene:

- the **spectral** axis splits the spectral rows: rank ``c`` of it renders
  rows ``[c S / n_spectral, (c + 1) S / n_spectral)``, each keyed by its
  global index (``row_key(seed, s, chunk)``), so a row's stream does not
  depend on the rank that renders it;
- the **sample** axis splits each pixel's samples by global sample id:
  rank ``r`` traces ids ``[r n, (r + 1) n)`` of every chunk's ``n_sample n``
  (:func:`..ops.tracer.lane_partition`'s ``sample_offset`` and
  ``spp_stride``). With the ``independent`` sampler a sample's stream
  depends only on (seed, row, chunk, pixel, id), so the ranks together
  trace the single-device sample set and the estimate equals the
  single-device one up to float summation order.

The chunk plans are the reference's sharded ones, computed from the global
budget: one chunk for the ``independent`` plane-parallel sampler, the
spherical and the polarized plane-parallel families (unless ``spp_chunk``
is given), ``MAX_PATHS_PER_DISPATCH // (S N)`` samples a chunk for a
structured sampler, ``// 8`` and ``// 16`` of it for canopies and terrain.
Every chunk takes ``spp_local = ceil(spp_chunk / n_sample)`` samples a
rank, so ``spp`` in the result reports what was traced, ``n_chunks *
spp_local * n_sample``, which may exceed the budget.

Each rank sums its chunks' estimates; then one ``all_reduce(SUM)`` a output
over the sample group, divided by ``n_sample * n_chunks`` (the reference's
single ``pmean`` after its chunk scan), and one ``all_gather`` over the
spectral group, so that every rank returns the whole ``[S, N]`` (``[S, N,
4]``) on its device. A forward-mode dual (:mod:`..sensitivity`) is reduced
as its primal and its tangent: a collective on a dual reduces the primal
alone and leaves each rank's tangent as it was, without an error.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

from ..core.device import resolve_device
from ..ops.tracer import MAX_PATHS_PER_DISPATCH, row_key

__all__ = [
    "make_render_mesh",
    "render_sharded",
    "render_polarized_sharded",
    "render_spherical_sharded",
    "render_spherical_polarized_sharded",
    "render_canopy_sharded",
    "render_canopy_polarized_sharded",
    "render_dem_sharded",
    "reduce_sum",
    "gather_rows",
]

AXES = ("spectral", "sample")


def make_render_mesh(n_spectral=1, n_sample=None, device_type="cuda"):
    """A ("spectral", "sample") mesh over every rank of the process group
    (:func:`.multihost.initialize`): ``n_spectral`` x ``n_sample``, the
    sample axis (default: what remains) inner, so that rank ``c n_sample +
    r`` is (c, r). ``device_type`` is ``"cuda"`` (each rank on its current
    card) or ``"cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call eradiate_tpu_torch.parallel.initialize() (or "
            "torch.distributed.init_process_group) on every rank first"
        )
    world = dist.get_world_size()
    if n_sample is None:
        n_sample = world // n_spectral
    if n_spectral * n_sample != world:
        raise ValueError(f"mesh {n_spectral}x{n_sample} does not cover {world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_spectral, n_sample),
                      mesh_dim_names=AXES)


def _default_mesh(mesh, device):
    """``mesh``, by default every rank on the sample axis, of ``device``'s
    type."""
    if mesh is None:
        return make_render_mesh(1, None, torch.device(device or "cuda").type)
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"the mesh's axes must be {AXES}, got {mesh.mesh_dim_names}")
    return mesh


def _device(mesh, device):
    """The rank's render device: the mesh's type, on the current card."""
    dev = resolve_device(mesh.device_type if device is None else device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {device!r} does not match the mesh's {mesh.device_type!r}")
    return dev


def _validate(mesh, S):
    n_spectral, n_sample = mesh.shape
    if S % n_spectral != 0:
        raise ValueError(f"spectral batch {S} not divisible by mesh axis {n_spectral}")
    return n_spectral, n_sample


def _uniform_chunk_plan(spp, n_sample, spp_chunk):
    """Uniform chunks rounded up to cover the global budget: ``(n_chunks,
    spp_local, traced)``, ``traced >= spp``."""
    spp_chunk = min(spp_chunk or spp, spp)
    n_chunks = -(-spp // spp_chunk)
    spp_local = -(-spp_chunk // n_sample)
    return n_chunks, spp_local, n_chunks * spp_local * n_sample


def _capped_chunk(spp, rows, n_pix, cap, spp_chunk):
    """``spp_chunk``, by default the samples of a dispatch of ``cap`` paths
    where the budget exceeds it (the canopy and terrain rule)."""
    if spp_chunk is None:
        max_spp = max(1, cap // max(rows * n_pix, 1))
        if spp > max_spp:
            spp_chunk = max_spp
    return spp_chunk


# -- collectives ---------------------------------------------------------------


def _parts(x, group):
    """``(primal, tangent)`` of ``x`` with the group agreed on whether a
    tangent rides along: a rank without one takes zeros when another has
    one, so that every rank makes the same collectives."""
    primal, tangent = fwAD.unpack_dual(x)
    flag = torch.tensor([tangent is not None], dtype=torch.int32, device=primal.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if not bool(flag.item()):
        return primal, None
    return primal, torch.zeros_like(primal) if tangent is None else tangent


def reduce_sum(x, group):
    """The sum of ``x`` over ``group``; a forward-mode dual sums its primal
    and its tangent, each in a collective of its own."""
    primal, tangent = _parts(x, group)
    out = primal.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    if tangent is None:
        return out
    tan = tangent.clone()
    dist.all_reduce(tan, op=dist.ReduceOp.SUM, group=group)
    return fwAD.make_dual(out, tan)


def _gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def gather_rows(x, group):
    """The ranks' row blocks ``x`` stacked along the first axis in the
    group's rank order; a dual gathers its primal and its tangent."""
    primal, tangent = _parts(x, group)
    out = _gather(primal, group)
    return out if tangent is None else fwAD.make_dual(out, _gather(tangent, group))


# -- the shared chunk loop -----------------------------------------------------


def _render(rr, mesh, seed, n_chunks, spp_local, traced):
    """This rank's rows and samples of every chunk through ``rr`` (a
    :class:`..ops.tracer.RowRenderer`), reduced over the sample axis and
    gathered over the spectral axis."""
    n_spectral, n_sample = _validate(mesh, rr.rows)
    block = rr.rows // n_spectral
    first = mesh.get_local_rank("spectral") * block
    offset = mesh.get_local_rank("sample") * spp_local
    acc = m2_acc = None
    iterations = 0
    for chunk in range(n_chunks):
        outs = [rr.render(s, row_key(seed, s, chunk, rr.device), spp_local, offset,
                          spp_local * n_sample)
                for s in range(first, first + block)]
        a = torch.stack([o[0] for o in outs])
        m2 = torch.stack([o[1] for o in outs])
        iterations += sum(o[2] for o in outs)
        acc = a if acc is None else acc + a
        m2_acc = m2 if m2_acc is None else m2_acc + m2
    out = []
    for x in (acc, m2_acc):
        x = reduce_sum(x, mesh.get_group("sample")) / (n_sample * n_chunks)
        out.append(gather_rows(x, mesh.get_group("spectral")))
    a, m2 = out
    result = {"radiance": a[..., 0] if rr.stokes else a, "m2": m2, "spp": traced,
              "iterations": iterations}
    if rr.stokes:
        result["stokes"] = a
    return result


# -- the seven families ------------------------------------------------------------


def render_sharded(scene, sensor, config, spp, seed=0, mesh=None, spp_chunk=None, *,
                   device=None):
    """Sharded twin of :func:`..ops.tracer.render`. ``spp`` is the whole
    per-pixel budget; the ``independent`` sampler renders it in one chunk,
    a structured sampler in chunks of ``MAX_PATHS_PER_DISPATCH // (S N)``
    samples (``spp_chunk``), each rank tracing its slice of every pixel's
    global sample ids. ``device`` (default the mesh's) must be of the
    mesh's type. Returns ``radiance`` and ``m2`` [S, N], ``spp`` (traced)
    and this rank's ``iterations``."""
    from ..ops.tracer import row_renderer

    mesh = _default_mesh(mesh, device)
    rr = row_renderer(scene, sensor, config, device=_device(mesh, device))
    _, n_sample = _validate(mesh, rr.rows)
    if config.sampler == "independent":
        n_chunks, spp_chunk = 1, spp
    else:
        if spp_chunk is None:
            spp_chunk = max(1, MAX_PATHS_PER_DISPATCH // max(rr.rows * rr.n_pix, 1))
        spp_chunk = min(spp_chunk, spp)
        n_chunks = -(-spp // spp_chunk)
    spp_local = -(-spp_chunk // n_sample)
    return _render(rr, mesh, seed, n_chunks, spp_local, n_chunks * spp_local * n_sample)


def render_polarized_sharded(scene, sensor, config, spp, seed=0, mesh=None, spp_chunk=None, *,
                             device=None):
    """Sharded twin of :func:`..ops.tracer_polarized.render_polarized`:
    ``stokes`` [S, N, 4], ``radiance`` (= I), ``m2``, ``spp`` (traced) and
    this rank's ``iterations``."""
    from ..ops.tracer_polarized import row_renderer

    mesh = _default_mesh(mesh, device)
    rr = row_renderer(scene, sensor, config, device=_device(mesh, device))
    _, n_sample = _validate(mesh, rr.rows)
    return _render(rr, mesh, seed, *_uniform_chunk_plan(spp, n_sample, spp_chunk))


def _spherical(polarized, medium, surface, illum, sensor, config, spp, seed, max_iterations,
               mesh, spp_chunk, device):
    from ..ops.scene_state import SceneArrays
    from ..ops.tracer_spherical import MAX_ITERATIONS

    if polarized:
        from ..ops.tracer_spherical_polarized import row_renderer
    else:
        from ..ops.tracer_spherical import row_renderer
    if max_iterations != MAX_ITERATIONS:
        raise NotImplementedError(
            f"the port's spherical tracers cap a path at {MAX_ITERATIONS} events"
        )
    mesh = _default_mesh(mesh, device)
    scene = SceneArrays(medium=medium, surface=surface, illumination=illum)
    rr = row_renderer(scene, sensor, config, device=_device(mesh, device))
    _, n_sample = _validate(mesh, rr.rows)
    return _render(rr, mesh, seed, *_uniform_chunk_plan(spp, n_sample, spp_chunk))


def render_spherical_sharded(medium, surface, illum, sensor, config, spp, seed=0,
                             max_iterations=512, mesh=None, spp_chunk=None, *, device=None):
    """Sharded twin of :func:`..ops.tracer_spherical.render_spherical`
    (the reference's arguments: the scene's medium, surface and
    illumination apart)."""
    return _spherical(False, medium, surface, illum, sensor, config, spp, seed, max_iterations,
                      mesh, spp_chunk, device)


def render_spherical_polarized_sharded(medium, surface, illum, sensor, config, spp, seed=0,
                                       max_iterations=512, mesh=None, spp_chunk=None, *,
                                       device=None):
    """Sharded twin of
    :func:`..ops.tracer_spherical_polarized.render_spherical_polarized`."""
    return _spherical(True, medium, surface, illum, sensor, config, spp, seed, max_iterations,
                      mesh, spp_chunk, device)


def _canopy(polarized, scene, leaf_params, leaves, sensor, config, spp, seed, mesh, spp_chunk,
            tris, tri_params, device):
    if polarized:
        from ..ops.tracer_canopy_polarized import row_renderer
    else:
        from ..ops.tracer_canopy import row_renderer
    mesh = _default_mesh(mesh, device)
    rr = row_renderer(scene, leaf_params, leaves, sensor, config, tris, tri_params,
                      device=_device(mesh, device))
    _, n_sample = _validate(mesh, rr.rows)
    spp_chunk = _capped_chunk(spp, rr.rows, rr.n_pix, MAX_PATHS_PER_DISPATCH // 8, spp_chunk)
    return _render(rr, mesh, seed, *_uniform_chunk_plan(spp, n_sample, spp_chunk))


def render_canopy_sharded(scene, leaf_params, leaves, sensor, config, spp, seed=0, mesh=None,
                          spp_chunk=None, tris=None, tri_params=None, *, device=None):
    """Sharded twin of :func:`..ops.tracer_canopy.render_canopy`: the leaves
    and triangles on every rank, the chunks of the reference's canopy rule
    (``MAX_PATHS_PER_DISPATCH // 8`` paths) on every device."""
    return _canopy(False, scene, leaf_params, leaves, sensor, config, spp, seed, mesh,
                   spp_chunk, tris, tri_params, device)


def render_canopy_polarized_sharded(scene, leaf_params, leaves, sensor, config, spp, seed=0,
                                    mesh=None, spp_chunk=None, tris=None, tri_params=None, *,
                                    device=None):
    """Sharded twin of
    :func:`..ops.tracer_canopy_polarized.render_canopy_polarized`."""
    return _canopy(True, scene, leaf_params, leaves, sensor, config, spp, seed, mesh,
                   spp_chunk, tris, tri_params, device)


def render_dem_sharded(scene, dem, sensor, config, spp, seed=0, mesh=None, spp_chunk=None, *,
                       n_march=128, n_bisect=16, device=None):
    """Sharded twin of :func:`..ops.tracer_dem.render_dem` on the marched
    heightfield (the triangulated terrain renders on one device, as in the
    reference), in chunks of the reference's terrain rule
    (``MAX_PATHS_PER_DISPATCH // 16`` paths); ``n_march``/``n_bisect`` are
    the marcher's steps."""
    from ..ops.tracer_dem import row_renderer

    mesh = _default_mesh(mesh, device)
    rr = row_renderer(scene, dem, sensor, config, None, n_march, n_bisect,
                      device=_device(mesh, device))
    _, n_sample = _validate(mesh, rr.rows)
    spp_chunk = _capped_chunk(spp, rr.rows, rr.n_pix, MAX_PATHS_PER_DISPATCH // 16, spp_chunk)
    return _render(rr, mesh, seed, *_uniform_chunk_plan(spp, n_sample, spp_chunk))
