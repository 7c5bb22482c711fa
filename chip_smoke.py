#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

The paths run through ``eradiate_tpu_torch.run`` unless said otherwise.
BASELINE config 1 (``bench.py`` ``_c1``): a mono single-precision
plane-parallel Rayleigh atmosphere (AFGL, 550 nm) over a Lambertian surface
(rho = 0.5), sun at SZA 30, seen by a 76-angle ``mdistant`` hplane sensor at
4194304 spp. BASELINE config 4 (``_c4``): the same column in spherical shells
over a Hapke surface, sun at SZA 75, 15 view zeniths at 2097152 spp; at SZA 85
the sun-tau table is off and the exact NEE runs; with ``config.lr_flight``
through ``render_spherical`` (the sensitivity renders' entry point) the
flight and the exact slant depth are two launches. The scene of BASELINE
config 5 (``_c5``) with the scalar integrator: HET01 (one 2000-leaf cloud
instanced at 15 positions, 30000 leaf disks in a 100 m x 100 m x 15 m canopy)
over a Lambertian floor under the Rayleigh AFGL column without absorption, sun
at SZA 20, 19 view zeniths at 2097152 spp, footprint rectangle target; in four
forms: instanced; as two elements, which flattens it; ``c5_trees``, the crown
on a 6 m trunk as one abstract tree instanced at the 15 positions (instanced
leaves and instanced trunk triangles); ``c5_wood``, the leaf cloud beside a
mesh tree at the 15 positions, a wood skeleton of 6180 triangles that this
script writes as an OBJ file into a temporary directory from a seed
(flattened: 30000 disks and 92700 triangles). Config 1 and config 5 (as
``bench.py`` builds it, integrator ``{"type": "volpath", "stokes": True}``)
also run with polarized transport, in ``mono_polarized_single`` (``bench.py``
names ``mono_polarized``, the double-precision mode, whose path state the
JAX package keeps in float32 unless x64 is on; the port runs its double
modes in float64, phases 32-43: c5 in ``mono_polarized`` in phase 39). BASELINE config 2 (``_c2``): an RPV floor
under the AFGL Rayleigh column with a 0-2 km continental aerosol layer (tau
0.2 at 550 nm, the packaged Govaerts 2021 dataset, a tabulated phase
function on 181 nodes), sun at SZA 30, 76 view zeniths at 2097152 spp.
BASELINE config 3 (``_c3``): the synthetic CKD database over the
Sentinel-2A MSI band 4 response, a Lambertian floor of 0.2, 76 view zeniths
at 65536 spp on each of 56 spectral rows (7 bins x 8 g-points), in
``ckd_single``, and in ``ckd`` as ``bench.py`` names it (phase 36: float64
path state on the card, float32 on a TPU). Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build of the port's CUDA kernels from ``eradiate_tpu_torch/csrc``;
3. the collision-fetch kernel against its plain PyTorch twin on the card, at
   the main path's shapes (the merged c1 column and its lane count), on the
   unmerged 1200-layer column, on a table with flat runs, at lane counts of
   every remainder modulo 4, on queries from a misaligned ``q[1:]`` view,
   and on random columns at L = 1, L = 12287 (the search tree alone staged)
   and K = 16; the queries of ``test_tools.collision_fetch.stress_queries``
   (NaN, +-inf, -0.0, every level and one ulp either side): z, layer and
   fetched values bit pattern for bit pattern on every lane, fatal on any
   lane that differs; at L = 46 and L = 1200 the wrapper's call time (CUDA
   events around it), the kernel's device time (``torch.profiler``'s
   records of it), once more with the L2 cache flushed before each launch
   (128 MB written), and the twin's time, medians of 25;
4. the port on CUDA against the port on the CPU, c1 at 11 view zeniths and
   256 spp at one seed: BRF within 1e-4 relative (CUDA's expf/log1pf differ
   from the CPU's in the last ulp, which can flip a rare branch), and every
   pixel within |z| <= 5 of the variances;
5. c1 at full width: one warm-up run, then a timed run; the kernel's launch
   count over the timed run must equal its bounce iterations; then one more
   run with the profiler on for 40 of its collision fetches, for the
   kernel's device time a launch inside the run;
6. the shell, triangle and leaf launchers in the library, their ptxas
   reports, the blocks of the shell kernels that fit on an SM at 232
   and 1200 shells, and the shell wrappers' checkpoint stride and
   shared-memory sizes equal to the library's at 1 to 4096 shells;
7. the shell-flight (K2), slant-depth (K4) and shell-event (K3) kernels
   against their plain twins on the card: the c4 column at c4's lane count,
   with the lanes of a real first event (rays from the top of the atmosphere
   along the 15 view directions) and seeded interior lanes (steep descents,
   grazing rays, tangents below the ground); the unmerged 1200-shell column;
   a column with vacuum shells; a ragged lane count; and the slant
   stresses of ``eradiate_tpu_torch.test_tools.shells`` (points on shell
   radii, tangent radii on shell radii and at the ground, ``b`` above ``r``
   by rounding, ``p.w = +-0``, points above the top radius) on three
   columns (232 shells, the same with vacuum shells, 1200 shells) toward a
   direction along an axis and toward the SZA 85 sun, given to K3 with no
   flight so that its event points are the stress points; the slant loop's
   division (the IEEE division's fast path without its range check) against
   numpy's IEEE division on every divisor significand in [1, 2) and on
   random pairs inside and beyond its range, bit for bit; the flight's
   stresses of ``test_tools.shells.flight_stress_inputs`` on six columns
   (232 shells, the same with vacuum shells, 1200 shells, 229 shells with
   runs of vacuum shells across checkpoint levels, its lowest 17 with one
   vacuum run, one shell): ``v`` on a
   level's G inside vacuum runs and at checkpoint levels, ``tau_s`` at 0
   and one ulp either side of ``tau_max``, ``t_max = 0``, ``x0 = +-0``,
   ``b2`` at ``fl(r_k^2)`` and one ulp either side, grazing lanes in the
   top shell, random lanes with flights cut short; the flight loop's square
   root (the IEEE root's fast path without its range check) against
   ``sqrtf`` on every float32 of its range. K4 is given the event points of
   K2's flight. collide, layer, t_col, tau_sun and tau bit pattern for bit
   pattern (``TAU_BLOCKED`` on the same lanes; differing lanes counted),
   and K4's depths equal to K3's; the mean first shell the slant paths
   cross, the mean loop start of a warp (the least of its lanes') and the
   crossed segments a lane; the flight's level passes a lane and those of
   the slowest lane of a warp, now and under the two sweeps before, as the
   kernels' emulation counts them on the set's lanes (``test_tools.shells
   .shell_flight_checkpointed``, not a count taken in the kernel:
   ``tools/chip_flight_variants.py`` holds the kernel's own count to it
   lane for lane; fatal where an emulated lane passes more than L + S
   levels, S the checkpoint stride), the share of lanes that resume at the
   sweep's stop and walk past it, and the levels a flight has to read
   (``flight_levels``); kernel and twin timed with CUDA events (median);
8. the port on CUDA against the port on the CPU, c4 at 15 view zeniths and
   256 spp at one seed, SZA 75 and SZA 85: every pixel within |z| <= 5,
   the median pixel within 1e-4 relative and every pixel within 5e-2 (CUDA's
   libm differs from the CPU's in the last ulp, and the event positions
   drift apart until a few paths take another branch);
9. c4 at full width, SZA 75: one warm-up run, then a timed run; shell-flight
   launches must equal event iterations; then one more run with CUDA events
   around each launch, for the kernel's device time a launch on the real
   event mix, and the flight statistics of phase 7 on the lanes of its
   eighth launch;
10. the SZA 85 variant at full width (2097152 spp): shell-event launches
    must equal event iterations; device time a launch as phase 9;
11. the four leaf-sweep kernels (nearest and any hit, flat and instanced)
    against their plain versions on the card: HET01's leaves, rays of three
    kinds (from the top of the atmosphere toward the footprint, from inside
    a crown in random directions, shadow rays toward the sun), clipped to
    the canopy's box as the tracer clips them; a ragged lane count; rays
    that miss the box; and, as stresses of the culls, random disks with
    rays aimed at their rims from 0.5-3 units and from 100x farther, and
    disks whose normals have components of exactly +-0. All four traverse
    a bounding volume hierarchy built on the host once per render, the flat
    ones (``leaf_bvh_nearest_kernel``, ``leaf_bvh_occluded_kernel``) in one
    level, the instanced ones (``leaf_ibvh_nearest_kernel``,
    ``leaf_ibvh_occluded_kernel``) in two, the instances' boxes above the
    canonical cloud's hierarchy (each build's time, depths, leaves and size
    printed, a rebuild held bit for bit, and the leaves, or the instance
    boxes and canonical leaves, a ray reaches). They are also held on rays
    with direction components exactly +-0 along the planes of the disks'
    box faces and rays at grazing incidence; the flat ones on exact ties of
    the hit distance inside one 512-disk chunk and across two (the copy
    across with the larger box, so that the traversal meets the higher
    chunk first); the instanced ones on a tie table with ties also across
    instances (opposite normals, the lower instance winning from a higher
    chunk) and four coincident disks with normals n, n, n, -n, and on
    instances 200 units from the world origin with rays from near it. Every
    output equal bit pattern for bit pattern on every lane, differing lanes
    counted and printed; each kernel timed with CUDA events (median of 25)
    at the path's lane count, its plain version once on a seeded subset of
    2^16 of those lanes, in slices that fit the card's memory;
12. the port on CUDA against the port on the CPU, the c5 scene at 19 view
    zeniths and 64 spp at one seed, instanced and flat: every pixel within
    |z| <= 5, the median pixel within 1e-4 relative;
13. the c5 scene at full width through the instanced kernels: a warm-up,
    then a timed run; nearest-hit and any-hit launches must each equal the
    bounce iterations;
14. the same canopy as two elements (positions split 8 + 7) at full width
    through the flat kernels, and its BRF against phase 13's within
    |z| <= 5 per pixel;
15. c4 at SZA 75 with ``lr_flight`` at full width: a warm-up, then a timed
    run; shell-flight and slant-depth launches must each equal the event
    iterations; its radiance against the exact-NEE render (sun-tau table
    off, shell-event kernel) of the same scene and seed, bit for bit; device
    time a launch of both kernels as phase 9;
16. the four triangle-sweep kernels (K8 flat, K9 instanced) against their
    plain versions on the card, as phase 11: the trunks of ``c5_trees`` and
    the soup of ``c5_wood`` with the three kinds of rays clipped to the
    mesh's box (plain versions on 2^16 seeded lanes), a ragged
    lane count, rays beside the box, and rays aimed at shared edges and
    vertices of the skeleton's closed cylinders from 0.5-3 m and from
    50-300 m. All four traverse a bounding volume hierarchy built on the
    host once per render, the flat ones (``bvh_nearest_kernel``,
    ``bvh_occluded_kernel``) in one level, the instanced ones
    (``tri_ibvh_nearest_kernel``, ``tri_ibvh_occluded_kernel``) in two, the
    instances' boxes above the canonical soup's hierarchy (each build's
    time, depths and size printed, a rebuild held bit for bit, and the
    leaves, or the instance boxes and canonical leaves, a ray reaches). The
    flat ones are also held on rays with direction components exactly +-0
    through the planes of box faces, and on exact ties of the hit distance
    inside one 512-triangle chunk and across two, placed so that the
    traversal meets the higher chunk first; the instanced ones on the trunk
    soup with direction components exactly +-0 near and far, with normal
    components of exactly +-0, and at three positions 2 km from the world
    origin with rays from near it, and on a tie soup at nine offsets with
    ties also across instances, placed so that the walk meets the higher
    instance first; then the instanced kernels on the skeleton as canonical
    soup (N = 6180, I = 15, its two-level build printed) against the flat
    kernels on its 92700 triangles, both timed, the instanced ones with
    their bound;
17. the port on CUDA against the port on the CPU, ``c5_trees`` and
    ``c5_wood`` (the latter with a 12-branch skeleton, 4860 triangles: the
    CPU's dense sweep of 92700 would take minutes) at 19 view zeniths and
    64 spp: the gate of phase 12;
18. ``c5_trees`` at full width: leaf and triangle nearest-hit and any-hit
    launches (instanced kernels) must each equal the bounce iterations;
19. ``c5_wood`` at full width, the same through the flat kernels; the BRF of
    both printed beside phase 13's;
20. polarized c1 (Stokes output) on CUDA against the CPU, 11 view zeniths
    and 256 spp at one seed: I within 1e-4 relative, and every Stokes
    component of every pixel within |z| <= 5 (of the two runs' I
    variances, the only ones kept);
21. polarized c1 at full width (76 x 2097152, half c1's samples): one run with the profiler on
    for 48 bounce iterations after the first 100 (it warms the card; every
    profiled run ends once its window has closed), then a timed run; the
    collision fetch's launches must equal the bounce iterations, and no
    other kernel launches; wall, samples/s, peak memory,
    I, Q/I and DoLP at the view nearest nadir, CUDA kernels and device time
    an iteration, the busy share (device time over the timed wall) and
    K1's device time a launch inside the run;
22. polarized c5 on CUDA against the CPU, 64 spp, the scene exactly as
    ``bench.py`` builds it, instanced, flat and
    ``c5_trees``: the gate of phase 20; the launches of each CUDA run
    (K7; K5/K6; K7 and K9) go into the ``kernels`` line;
23. polarized c5 at full width (instanced, 19 x 2097152), as phase 21 with
    40 iterations profiled after the first 20: K7 nearest-hit and any-hit
    launches must each equal the bounce iterations, each one's device time
    a launch inside the run; the BRF at nadir beside phase 13's;
24. the collision-fetch kernel against its twin as in phase 3 on c2's
    merged column (46 layers, K = 4: albedo, the Rayleigh and aerosol blend
    weights, the depolarisation) at the c2 path's lane count, timed as in
    phase 3 with its bound, ragged and from a misaligned view, and on c3's
    most absorbing row (37 layers, K = 3) at its lane count;
25. c2 (``mono_single``) and c3 (``ckd_single``) on CUDA against the CPU,
    11 view zeniths and 256 spp (c3: 64 spp a row) at one seed: BRF within
    1e-4 relative and
    every pixel within |z| <= 5, and so every raw spectral row (c3's 56)
    before the CKD aggregation;
26. c2 at full width (76 x 1048576, half c2's samples), as phase 21 with 48 iterations
    profiled after the first 64: K1's launches must equal the bounce
    iterations, and no other kernel launches; K1's device time a launch
    inside the run;
27. c3 at full width (76 x 65536 x 56 rows), the same with 48 iterations
    profiled after the first 100; the iterations of each row, which must
    sum to K1's launches;
28. polarized c4 (the ``stokes`` integrator through
    ``render_spherical_polarized``) on CUDA against the CPU, 15 view
    zeniths and 256 spp at one seed, at SZA 75 (K2 and the sun-tau table),
    SZA 85 (K3) and as path B (``lr_flight``: K2 then K4): the card's c4
    gate on I (|z| <= 5, the median pixel within 1e-4 relative) and
    |z| <= 5 on Q, U and V with I's variances; on the card, path B's Stokes
    vectors and iterations equal, bit for bit, the exact-NEE render (K3) of
    the scene without its sun-tau table;
29. polarized c4 at full width, SZA 75 (15 x 524288: 4 of the reference's
    chunks of ``MAX_PATHS_PER_DISPATCH // 15`` samples, each with its own
    key), as phase 21 with 48 event iterations profiled after the first 64:
    K2's launches must equal the event iterations summed over the chunks,
    and no other kernel launches; wall, samples/s, chunks, iterations a
    chunk, busy share, peak memory, CUDA kernels and device time an
    iteration, K2's device time a launch inside the run; I, Q/I and DoLP at
    the view nearest nadir beside phase 9's scalar BRF;
30. polarized c2 (the aerosol as ``tab_polarized``): CUDA against the CPU
    at 11 view zeniths and 256 spp (I within 1e-4, Stokes |z| <= 5), then
    at full width (76 x 1048576, half c2's samples) as phase 26: K1's
    launches must equal the
    bounce iterations, K1's device time a launch inside the run;
31. c3 in ``ckd_polarized_single`` on CUDA against the CPU, 11 view zeniths
    and 64 spp a row: each of the 56 raw rows' I within 1e-4 relative and
    its Stokes components within |z| <= 5, and so the aggregated I; K1's
    launches must equal the bounce iterations summed over the rows;
32. the float64 build of the collision fetch (``collision_fetch_f64_kernel``)
    against its plain twin on the card, as phase 3: the c1 column compiled
    in ``mono_double`` at the c1 lanes (timed, with its bound over the
    float64 rate), ragged and from a ``q[1:]`` view, the unmerged column,
    the table with flat runs, random columns at L = 1 and 12287 (a 128 KiB
    search tree) and K = 16; float64 NaN, +-inf, -0.0 and every level one
    ulp either side among the queries;
33. the float64 builds of K2, K3 and K4 (``shell_flight_f64_kernel``,
    ``shell_event_f64_kernel``, ``slant_tau_f64_kernel``, on the float32
    kernels' designs: one sweep with checkpoints of two float64 sums, the
    slant from the first crossed shell, the shells in shared memory): their
    blocks an SM, shell caps and the wrapper's float64 layout mirror against
    the library's (fatal if one differs), then against their plain twins on
    the card, bit pattern for bit pattern, K4 at K2's event points equal to
    K3's tau_sun: the c4 column compiled in ``mono_double`` at c4's lane
    count (timed, with its bound), ragged, the unmerged 1200-shell column,
    the slant and the flight stresses of phase 7 taken into float64 and
    made in float64 (each tie and ulp a float64 one), and a planet of 1e6
    km (1200 shells of 0.1 km, which float32 cannot tell apart);
34. the port on CUDA against the port on the CPU in the double modes at one
    seed: c1 (``mono_double``, 11 view zeniths, 256 spp), polarized c1
    (``mono_polarized_double``, 64 spp) and c4 at SZA 75 and 85
    (``mono_double``, 256 spp): every raw pixel's radiance and second
    moment within 1e-10 relative, Stokes components within 1e-10 of I,
    every pixel within |z| <= 5;
35. c1 at full width (76 x 2097152, half c1's samples) in ``mono_double``
    (K1's float64 build) and, the same
    way, in ``mono_single``: a run with the profiler on for 48 bounce
    iterations after the first 100, ended there, then a timed run; K1's
    launches equal to the iterations, no other kernel; wall, samples/s,
    ms an iteration, CUDA kernels and device time an iteration, busy share,
    device time by kernel family, K1's device time a launch, peak memory;
36. c3 at full width in ``ckd``, as ``bench.py`` names it (K1's float64
    build, 56 rows), the same way; its ``ckd_single`` numbers are phase 27's;
37. c4 at SZA 75 at full width in ``mono_double`` (no sun-tau table in a
    double mode: K3's float64 build, the exact NEE) and in ``mono_single``
    (K2 and the table), the same way with 32 event iterations after 16;
    path B (``lr_flight``) in ``mono_double`` at full width:
    K2's and K4's float64 builds launched once an event, radiance and
    iterations bit for bit with the exact-NEE render, then one more run with
    CUDA events around each launch (K2 f64 and K4 f64 a launch in the run);
    then each double run's numbers beside its single mode's;
38. the float64 builds of the leaf sweeps (``leaf_bvh_nearest_f64_kernel``,
    ``leaf_bvh_occluded_f64_kernel``, ``leaf_ibvh_nearest_f64_kernel``,
    ``leaf_ibvh_occluded_f64_kernel``) against their float64 plain versions
    on the card, bit pattern for bit pattern on every lane: HET01 compiled
    in ``mono_double``, flat (N = 30000) and instanced (N = 2000, I = 15),
    at the path's lane count (timed, with each kernel's device and call
    time, its plain version's on 2^16 seeded lanes, what a ray reaches and
    its bound over the float64 rate, beside phase 11's float32 device
    time), ragged and beside the box; random disks with rays at their rims
    from 0.5-3 and 50-300 units and with normal components of +-0; the
    float64 tie table (two-, three- and four-way ties inside a chunk,
    whose float64 normals the kernels sum again in index order, ties
    across chunks and, instanced, across instances); direction components
    exactly +-0 near and far, grazing incidence, and instances 200 units
    from the world origin;
39. c5 as ``bench.py`` builds it (instanced HET01, the ``stokes``
    integrator, 19 x 2097152) in ``mono_polarized``, the double mode
    ``bench.py`` names, at full width, as phase 23: K7's float64 builds
    launched once an iteration each and nothing else, their device time a
    launch inside the run; wall, samples/s, iterations, kernels and device
    time an iteration, busy share, peak memory and the BRF at nadir beside
    phase 23's ``mono_polarized_single`` numbers;
40. the flat and the instanced c5 scene in ``mono_double`` at full width
    the same way (K5/K6's and K7's float64 builds), beside phases 13 and
    14; then both forms in ``mono_double`` and the instanced one in
    ``mono_polarized_double`` at 64 spp on the card against the CPU, with
    the gate of phases 12 and 22, their worst pixel difference printed;
41. the float64 builds of the triangle sweeps (``bvh_nearest_f64_kernel``,
    ``bvh_occluded_f64_kernel``, ``tri_ibvh_nearest_f64_kernel``,
    ``tri_ibvh_occluded_f64_kernel``) against their float64 plain versions
    on the card, bit pattern for bit pattern on every lane: ``c5_trees``'
    trunks at their 15 positions and ``c5_wood``'s 92700 triangles compiled
    in ``mono_double``, at the path's lane count (timed, with each kernel's
    device and call time, its plain version's on 2^16 (trunks) and 2^14
    (wood) seeded lanes, what a ray reaches and its bound over the float64
    rate, beside phase 16's float32 device time), ragged and beside the
    box; the wood skeleton (flat, or at three offsets) in float64 with rays
    at its shared edges and vertices and rays exactly at its vertices (a
    cap's apex joins 12 triangles, a side vertex 6: ties of three and more,
    whose float64 normals the kernels sum again in index order) from 0.5-3
    m and 50-300 m; the float64 tie soups (ties inside a chunk and across
    two, placed so that the walk meets the higher chunk first, and across
    instances); direction components exactly +-0 near and far; the trunks
    at their vertices, and at three positions 2 km from the world origin;
    then the instanced kernels on the skeleton as canonical soup (N = 6180,
    I = 15) against the flat ones on its 92700 triangles in float64, both
    timed, the instanced ones with their bound;
42. ``c5_trees`` and ``c5_wood`` in ``mono_double`` at full width (19 x
    2097152), as phase 40: the leaves' and the triangles' float64 builds
    launched once an iteration each and nothing else; wall, samples/s,
    iterations, kernels and device ms an iteration, busy share, peak memory,
    each triangle kernel's device time a launch inside the run, and the
    wall and BRF at nadir beside phases 18 and 19's ``mono_single`` runs;
43. ``c5_trees`` in ``mono_double`` and ``mono_polarized_double`` and
    ``c5_wood`` (the 12-branch skeleton of phase 17) in ``mono_double`` at
    64 spp on the card against the CPU, with the gate of phases 12 and 22,
    their worst pixel difference printed;
A.  c1's column over ``rtls`` with the scene class's defaults (f_iso 0.209,
    f_vol 0.081, f_geo 0.004) at full width (76 x 4194304, ``mono_single``),
    as phase 35: a run with the profiler on for 48 bounce iterations after
    the first 100, ended there, then a timed run; K1's launches equal to the
    iterations and no other kernel; wall, samples/s, ms and CUDA kernels an
    iteration, device ms an iteration and busy share, beside phase 35's c1
    over its Lambertian floor;
B.  c2's atmosphere (the 0-2 km continental aerosol, ``tab``, K1 at K = 4)
    over ``ocean_legacy`` at 5 m/s wind (its other parameters at their
    defaults) at full width (76 x 1048576, as phase 26), the same way, beside phase 26's
    c2 over its RPV floor;
C.  c1's column on CUDA against the CPU at 11 view zeniths and 256 spp, as
    phase 4 (BRF within 1e-4, |z| <= 5), with the target off the origin,
    over every kind of the reference's ``_EVAL`` that the phases before do
    not run (``rtls``, ``bilambertian``, ``ocean_legacy``, ``ocean_grasp``,
    ``mqdiffuse``, ``bitmap``, ``checkerboard``, ``maignan`` and
    ``ocean_mishchenko`` in ``mono_single``) and the three composites
    (``central_patch``, ``opacity_mask``, ``selectbsdf``); ``rtls`` and
    ``bitmap`` also in ``mono_double`` (as phase 34, within 1e-10) and in
    ``mono_polarized_single`` (as phase 20);
D.  c4 at SZA 75 under c2's continental aerosol (the scalar ``tab`` phase;
    K2) on CUDA against the CPU at 256 spp with phase 8's gate; the c5
    scene instanced (K7) over a ``checkerboard`` ground and over a
    ``central_patch`` ground (an ``rtls`` patch), and polarized under c2's
    aerosol (``tab_polarized`` over a canopy), at 16 spp with phase 12's
    and phase 22's gates; then the seconds phases A-D took;
E.  c1's column seen by a ``perspective`` camera 2 km above the target,
    looking down at 30 degrees: a 128 x 128 film with the Gaussian filter,
    oversampled twice (65536 sub-pixel rays) at 512 spp, as phase A
    (profiled window of 16 iterations after 4); then against the CPU (8 x 8
    film, 64 spp: radiance within 1e-4 relative, |z| <= 5);
F.  on c1's column, timed once each (K1's launches equal to the
    iterations, no other kernel; wall, samples/s, the worst pixel's
    relative standard error): ``distant_flux`` 32 x 32 at 65536 spp with
    its radiosity and albedo, ``mpdistant`` 64 x 64 at 16384 spp over a 10
    km rectangle on the reference test's ``selectbsdf`` floor (halves of
    0.1 and 0.9), and a constant sky of radiance 1 at c1's 76 views and
    1048576 spp; each against the CPU (8 x 8, or 11 views, at 64 spp; the
    radiosity within 1e-4 too);
G.  c1 at 76 views and 262144 spp with the ``independent`` sampler (the
    regenerative loop), then ``stratified`` and ``ldsampler`` (the one-shot
    loop, in chunks of 2^21 // 76 samples a pixel, the budget rounded up to
    whole chunks): samples/s and the worst pixel's relative standard error
    beside the independent run's; K1's device time a launch inside the
    stratified run (48 launches after 8); both structured kinds against the
    CPU at 11 views and 64 spp;
H.  the c5 scene as ``bench.py`` builds it (instanced HET01) lit by
    ``SpotIllumination.from_size_at_target`` (a 50 m spot at the plot's
    centre, beam half-width 30 degrees, 86.6 m up) and seen by a 128 x 128
    box ``perspective`` camera 90 m south of the plot and 70 m up: 128 spp
    in ``mono_single`` and, with Stokes output, 32 spp in
    ``mono_polarized_single`` (K7's launches equal to the iterations); K7
    nearest and any hit against their plain versions, bit for bit, on the
    run's own rays of an eighth launch (the path rays, and the shadow rays
    that end at the spot, finite ``t_max``; timed with their bound); both
    runs against the CPU on an 8 x 8 film at 64 spp with the canopy gate
    (lit pixels within 2e-3, the median within 1e-4, |z| <= 5 of I, Q, U
    and V; dark pixels dark in both); then the seconds phases E-H took.
I.  DEM terrain (``DEMExperiment``) at full width in ``mono_single``: c1's
    column over a 15 km x 15 km tile at 30 m posts (a 501 x 501 gaussian
    hill 1 km high, sigma 2 km; the size of a Copernicus GLO-30 / SRTM
    tile crop), Lambertian 0.5, SZA 30, 19 view zeniths at 1048576 spp over
    a rectangle target on the central 4 km x 4 km at z = 1.1 km. The
    marched heightfield (128 steps, 16 bisections; plain PyTorch, no kernel
    of the port): a profiled warm-up window, then a timed run (wall,
    samples/s, iterations, CUDA kernels and device ms an iteration, busy
    share). Triangulated (500,000 triangles through K8): the hierarchy's
    build time apart from the render, a profiled warm-up window (K8's
    device ms a launch inside the run), then a timed run: K8 nearest
    launches equal to the iterations, any hit to twice them;
J.  K8 and its float64 build on the terrain soup, on the rays of an eighth
    launch of phase I's triangulated run (nearest hit on the path rays, any
    hit on the shadow rays), against their plain versions bit for bit on a
    2^14-lane sample
    (the plain sweep run only on the 512-triangle chunks whose boxes a ray's
    clipped segment reaches, which leaves its result the dense sweep's),
    with call time, device time and bound;
K.  the port on CUDA against the port on the CPU on the 33 x 33 hill
    (``gaussian_hill(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33)``,
    SZA 60, three view zeniths over a 4 km x 4 km target, 64 spp), both
    intersectors: ``mono_single``, ``ckd_single`` (one bin of 4 g-points)
    and ``mono_polarized_single`` (a scalar result) within 1e-4 relative and
    |z| <= 5, ``mono_double`` within 1e-10 (K8's float64 build); then the
    seconds phases I-K took.
O.  the sharded renders (``eradiate_tpu_torch.parallel``): (a) one NCCL
    rank in this process (a ``file://`` store under ``build/sharded``)
    renders c1 at full width through ``run(exp, mesh=make_render_mesh(1,
    1))``, bit for bit phase 5's ``mesh=None`` render at the same seed, K1
    launched once an iteration; (b) two ranks on the one card over gloo, through the dry
    run (``eradiate_tpu_torch.parallel.dryrun``; the ranks load the kernels
    phase 2 built): c1 at full width, 2097152 spp a rank, within 1e-5
    relative of phase 5's render, K1 launched once an iteration on each
    rank, every family at the dry run's size against its unsharded render
    (rtol 3e-5; the stratified sampler |z| <= 5), each rank's wall beside
    the single render's; (c) the same on two cards over NCCL where there
    are two, else a line that says it did not run.
P.  the command line (``python -m eradiate_tpu_torch.cli render``) in a
    subprocess with ``ERADIATE_TPU_RNG_SEED`` at the script's seed, loading
    the kernels phase 2 built: c1 as a JSON config (76 VZA x 4194304 spp in
    the measure, ``--mesh auto``), its ``.npz`` bit for bit phase 5's
    in-process render, K1 launched once an iteration (the launches the
    command prints); HET01 under the Rayleigh column as a
    ``CanopyAtmosphereExperiment`` config (its 2000 leaves written out, 19
    VZA x 65536 spp), bit for bit an in-process ``run`` of the same
    experiment at the same seed, with the same launches (K7); the
    subprocesses' walls beside the in-process ones.
Q.  the seven canonical scenes of ``test_tools/test_cases`` that phases
    1-O do not run (``rpv_afgl1986``, ``het04a1``, ``het06``, the two GRASP
    oceans, ``rami4atm``, ``spherical_rpv``), in ``mono_single`` through
    ``run(..., device="cuda")`` at the samples and seed of the reference's
    regression tier (``tests/regression/test_self_regression.py``): each
    held to its pin in ``tests/regression_references`` by the port's
    ``SidakTTest`` (threshold 0.01 over the pixels, variances floored at
    (1e-5 x radiance)^2) and ``RMSETest``, and against the CPU at the same
    seed under its tracer's gate (plane-parallel 1e-4 relative; spherical
    the median 1e-4 and 5e-2; canopies 2e-3 and the median 1e-4, at 64 spp;
    all |z| <= 5), with the kernels each scene must launch (K1, also on the
    oceans' empty column; K5 and K6 on het04a1's 22,500 flattened disks; K7
    and K9 on het06; K2 on ``spherical_rpv``) and every scene's launches
    printed.

The CPU sides of the canopy phases' CUDA-against-CPU gates (12, 17, 22,
40, 43, D) render in a pool of four background processes (one thread each,
no card), submitted after the build, so that their minutes overlap the
card's work, and those of 25, 31, E-H, K and Q in a second pool of two; the
script ends both pools on exit. The script prints its own total (seconds
from its start) before the kernels line.

It prints a ``{"kernels": [...]}`` line (each kernel with its launches on its
main path, its error against the plain version, its call time (``ms``) and
device time (``device_ms``, without the wrapper's host time: the
durations of its CUDA kernel in ``torch.profiler``'s records, or CUDA
events around calls enqueued while the card spins where the profiler kept
too few, as ``device_by`` says), the plain version's, the lane counts of
both, its bound on this card and what bounds it; the collision fetch also
its device time with the L2 flushed and a launch inside the c1 run,
``flushed_device_ms`` and ``run_device_ms``; a sweep's bound counts the
exact tests at item granularity, and the
slant depth's the distinct segments of each path, so that each is the same
whatever cull or order implements it, the flight's the levels each lane
has to read; the shell kernels also with their device time a launch inside
the full-width runs, ``run_ms``; a sweep's nearest hit with what a ray
reaches of its hierarchy, ``reach``; the instanced triangle kernels with
their time and bound on the wood skeleton, ``skeleton``; every kernel its
launches on the polarized paths, ``polarized_launches``, and K1, K2 and
K7 their device time a launch inside the polarized full-width runs,
``polarized_run_ms``, by path: K1 on c1 and c2, K2 on c4, K7 on c5; the four
float64 builds as entries of their own, ``collision_fetch_f64`` (launches on
c1 in ``mono_double``, its device time a launch inside that run and inside
c3's in ``ckd``), ``shell_event_f64`` (c4 SZA 75 in ``mono_double``),
``shell_flight_f64`` and ``slant_tau_f64`` (path B at full width, with
their device time a launch inside that run, ``run_ms``), and the
leaf sweeps' ``ray_leaves_nearest_f64``, ``ray_leaves_occluded_f64`` (the
flat c5 in ``mono_double``), ``ray_leaves_nearest_instanced_f64`` and
``ray_leaves_occluded_instanced_f64`` (c5 in ``mono_polarized``), and the
triangle sweeps' ``ray_tris_nearest_f64``, ``ray_tris_occluded_f64``
(``c5_wood`` in ``mono_double``), ``ray_tris_nearest_instanced_f64`` and
``ray_tris_occluded_instanced_f64`` (``c5_trees`` in ``mono_double``), with
their launches on the other double paths, ``launches_on``, and device time
a launch inside the full-width runs, ``run_device_ms``; their bounds over
the float64 rate; every kernel its launches on phases A-D,
``surface_launches``, and on E-H, ``sensor_launches``; K1 its device time
a launch inside A and B, ``surface_run_device_ms``, inside E's camera run,
``perspective_run_device_ms``, and inside G's one-shot run,
``one_shot_run_device_ms``; K7's any hit its times and bound on H's shadow
rays, ``spot_shadow_rays``; each kernel its launches on the command line's
renders of P, ``cli_launches``, and on Q's scenes, ``canonical_launches``)
and the
``nvidia-smi`` line
before the last line, ``{"ok": true,
"device": {...}}``. Without a CUDA device, or outside the repository, it
exits non-zero and prints no result. It imports neither ``jax`` nor
``eradiate_tpu`` and checks so at its end.
"""

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_VZA = 76
SPP_C1 = 4194304
N_VZA_C4 = 15
SPP_C4 = 2097152
N_VZA_C5 = 19
SPP_C5 = 2097152
SPP_C2 = 2097152
SPP_C3 = 65536
#: Depth cuts that keep the script inside its time limit beside phases O-Q:
#: half of c1's samples in the polarized c1 run (21) and phase 35's c1 pair,
#: a quarter in phase M's c1 passes, half of c2's in c2 at full width (26, B)
#: and in the polarized c2 run (30), a quarter of c4's in polarized c4 (29:
#: 4 of the reference's chunks, not 16), half of c5's in the DEM tile (I)
SPP_C1_HALF = SPP_C1 // 2
SPP_C1_QUARTER = SPP_C1 // 4
SPP_C2_HALF = SPP_C2 // 2
SPP_C4_POLARIZED = SPP_C4 // 4
#: Spectral rows of c3 in ``ckd_single``: the 7 bins of Sentinel-2A MSI band 4
#: times 8 g-points.
ROWS_C3 = 56
SEED = 1
#: Branches of the wood skeleton of the ``wood`` form (24 triangles each).
WOOD_BRANCHES = 256
#: Lanes on which a sweep kernel is held against its plain version.
PLAIN_LANES = 2**18
#: Lanes of the seeded sample on which the sweep checks at a path's lane
#: count run the plain versions (phases 11, 16, 38 and 41).
PATH_PLAIN_LANES = 2**16
#: Lanes of the seeded sample of phase 16's ragged and beside-the-box
#: checks on c5_wood's 92,700 triangles, and of its check at the path's
#: lanes (2^16 before, 21 s of the script).
WOOD_PLAIN_LANES = 2**13
WOOD_PATH_PLAIN_LANES = 2**14
#: Lanes of phase 16's sets of rays at the wood skeleton's edges and
#: vertices and of its flat tie and zero-direction soups (100,037 before;
#: the float64 sets of phase 41 take 32,768 and 65,536): their plain sweeps
#: on every lane took 2-7 s a set.
EDGE_LANES = 32_771
#: Lanes of each shell stress set: phase 7's flight sets, phase 33's
#: float64 sets and the shell depths' sets of phase L (a ragged count; each
#: stress kind is a part of every set).
STRESS_LANES = 100_037
#: The last lanes of a set, always in a plain version's sample.
SAMPLE_TAIL = 128
#: Lanes on which a timed sweep check counts its bound's exact tests and the
#: hierarchy a ray reaches (estimates, scaled to every lane).
STATS_LANES = 2**13
#: Samples a pixel of the c3 gates (phases 25 and 31), on CUDA and the CPU,
#: and their g-points a bin (:func:`_c3_gate`: 7 bins x 2 = 14 rows).
C3_GATE_SPP = 64
C3_GATE_NG = 2
C3_GATE_ROWS = 14
#: c2's atmosphere (``bench.py`` ``_c2``): AFGL Rayleigh with the 0-2 km
#: continental aerosol layer, tau 0.2 at 550 nm (phases B and D).
C2_ATMOSPHERE = {
    "type": "heterogeneous",
    "molecular_atmosphere": {"type": "molecular"},
    "particle_layers": [{"type": "particle_layer", "bottom": 0.0, "top": 2.0, "tau_ref": 0.2,
                         "dataset": "govaerts_2021-continental"}],
}
#: The surfaces of phase C on c1's column: every kind of the reference's
#: ``_EVAL`` that the phases before it do not run, and the three composites
#: (their maps and grids from a seed).
_surface_rng = np.random.default_rng(19)
SURFACE_CASES = {
    "rtls": {"type": "rtls"},
    "bilambertian": {"type": "bilambertian", "reflectance": 0.3, "transmittance": 0.2},
    "ocean_legacy": {"type": "ocean_legacy", "wind_speed": 5.0},
    "ocean_grasp": {"type": "ocean_grasp", "wind_speed": 2.0, "water_body_reflectance": 0.02},
    "mqdiffuse": {"type": "mqdiffuse", "data": _surface_rng.uniform(0.05, 0.5, (6, 9, 5))},
    "bitmap": {"type": "bitmap", "data": _surface_rng.uniform(0.1, 0.9, (6, 8)), "extent": 20.0},
    "checkerboard": {"type": "checkerboard"},
    "maignan": {"type": "maignan"},
    "ocean_mishchenko": {"type": "ocean_mishchenko", "wind_speed": 2.0},
    "central_patch": {"type": "central_patch", "bsdf": {"type": "rtls"},
                      "patch_bsdf": {"type": "lambertian", "reflectance": 0.8},
                      "patch_edges": 1.0},
    "opacity_mask": {"type": "opacity_mask", "nested_bsdf": {"type": "rpv"},
                     "opacity": _surface_rng.uniform(0.2, 1.0, (4, 4)), "extent": 5.0},
    "selectbsdf": {"type": "selectbsdf",
                   "bsdfs": [{"type": "lambertian", "reflectance": 0.1}, {"type": "rtls"},
                             {"type": "black"}],
                   "index_map": [[0, 1], [2, 1]], "extent": 4.0},
}
#: Phase C's target, off the origin, so that the composites' and textures'
#: surface points differ from the defaults.
SURFACE_TARGET = [0.3, -0.2, 0.0]
#: Samples a pixel of phase D's canopy gates (their CPU sides render in
#: :class:`CpuRenders` beside the 64-spp ones of phases 12-43; a quarter of
#: the samples keeps that process's added minutes from the card's host).
SPP_D = 16
#: Phase D's textured grounds under the c5 canopy (100 m wide): the
#: checkerboard's 500 m cells meet under its centre; an ``rtls`` patch 40 m
#: wide on the Lambertian floor.
C5_GROUNDS = {
    "checkerboard": {"type": "checkerboard", "reflectance_a": 0.1, "reflectance_b": 0.3},
    "central_patch": {"type": "central_patch",
                      "bsdf": {"type": "lambertian", "reflectance": 0.159},
                      "patch_bsdf": {"type": "rtls"}, "patch_edges": 0.02},
}

#: Phase E's camera on c1's column: 2 km above the target and 1.1547 km
#: south of it, looking down at 30 degrees from the vertical.
E_CAMERA = {"type": "perspective", "origin": [0.0, -1.1547, 2.0], "target": [0.0, 0.0, 0.0],
            "fov": 40.0, "rfilter": "gaussian", "rfilter_oversample": 2, "id": "m"}
#: Phase E-H at full width: E's film side and spp, F's, G's, H's. Cut to
#: keep the script inside its time limit on a loaded host: F's
#: ``distant_flux`` from 262144 spp and its constant sky from c1's 4194304,
#: G from 1048576, H from c5's 2097152 (128 scalar, 32 polarized).
E_FILM, E_SPP = 128, 512
F_FLUX_FILM, F_FLUX_SPP = 32, 65536
F_MPD_FILM, F_MPD_SPP = 64, 16384
F_SKY_SPP = 1048576
G_SPP = 262144
H_SPP, H_SPP_POLARIZED = 128, 32
#: Lanes of H's captured launches on which K7 is held to its plain versions
#: (a seeded sample; the kernels run on all of them).
H_PLAIN_LANES = 2**16
#: The CPU gates of E-H: 8 x 8 films (11 views for the mdistant cases) at 64 spp.
GATE_FILM, GATE_VZA, GATE_SPP = 8, 11, 64
#: The floor of the reference's mpdistant test
#: (``tests/system/test_mpdistant.py:20``): reflectance 0.1 and 0.9 on the
#: two halves of a 20 km square.
HALF_SURFACE = {"type": "selectbsdf",
                "bsdfs": [{"type": "lambertian", "reflectance": 0.1},
                          {"type": "lambertian", "reflectance": 0.9}],
                "index_map": [[0, 1]], "extent": 20.0}
#: Phase H's camera over the c5 plot: 90 m south of its centre and 70 m up.
H_CAMERA = {"type": "perspective", "origin": [0.0, -0.09, 0.07], "target": [0.0, 0.0, 0.0],
            "fov": 70.0, "id": "m"}


def _spot():
    """Phase H's spot: ``SpotIllumination.from_size_at_target`` over the c5
    plot's centre, a 50 m spot (the plot is 100 m wide) under a beam of 30
    degrees half-width, straight down."""
    from eradiate_tpu_torch.scenes.illumination import SpotIllumination

    return SpotIllumination.from_size_at_target(
        target=[0.0, 0.0, 0.0], direction=[0.0, 0.0, -1.0], spot_radius=0.05, beam_width=30.0)


def _sensor_case(case, size):
    """The scenes of phases E-G on c1's column (``_c1``'s atmosphere, floor
    and sun): ``perspective`` (:data:`E_CAMERA`, a ``size`` x ``size``
    film), ``distant_flux`` and ``mpdistant`` (``size`` x ``size``; mpdistant
    over a 10 km rectangle on :data:`HALF_SURFACE`), ``constant`` (a
    constant sky of radiance 1 over ``size`` views), and ``independent``,
    ``stratified``, ``ldsampler`` (c1 at ``size`` views with that
    sampler)."""
    from eradiate_tpu_torch import AtmosphereExperiment

    kw = dict(illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
              surface={"type": "lambertian", "reflectance": 0.5},
              atmosphere={"type": "molecular"},
              geometry={"type": "plane_parallel", "layer_merge_tol": 1e-3})
    mdistant = {"type": "mdistant", "construct": "hplane",
                "zeniths": np.linspace(-75, 75, size), "azimuth": 0.0, "id": "m"}
    if case == "perspective":
        kw["measures"] = {**E_CAMERA, "film_resolution": (size, size)}
    elif case == "distant_flux":
        kw["measures"] = {"type": "distant_flux", "film_resolution": (size, size), "id": "m"}
    elif case == "mpdistant":
        kw["surface"] = HALF_SURFACE
        kw["measures"] = {"type": "mpdistant", "film_resolution": (size, size),
                          "direction": [0.3, 0.1, 0.9], "id": "m",
                          "target": {"type": "rectangle", "xmin": -5.0, "xmax": 5.0,
                                     "ymin": -5.0, "ymax": 5.0}}
    elif case == "constant":
        kw["illumination"] = {"type": "constant", "radiance": 1.0}
        kw["measures"] = mdistant
    elif case in SAMPLER_CASES:
        kw["measures"] = {**mdistant, "sampler": case}
    else:
        raise ValueError(f"unknown case {case!r}")
    return AtmosphereExperiment(**kw)


SAMPLER_CASES = ("independent", "stratified", "ldsampler")


#: Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
#: bandwidth, and the float32 and float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
#: The script's start (set by main), for the total it prints.
T_START = time.perf_counter()
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
#: Each wrapper's CUDA kernel, by which its device time is read.
KERNELS = {
    "collision_fetch": "collision_fetch_kernel",
    "shell_flight": "shell_flight_kernel",
    "shell_event": "shell_event_kernel",
    "slant_tau": "slant_tau_kernel",
    "collision_fetch_f64": "collision_fetch_f64_kernel",
    "shell_flight_f64": "shell_flight_f64_kernel",
    "shell_event_f64": "shell_event_f64_kernel",
    "slant_tau_f64": "slant_tau_f64_kernel",
    "ray_leaves_nearest": "leaf_bvh_nearest_kernel",
    "ray_leaves_occluded": "leaf_bvh_occluded_kernel",
    "ray_leaves_nearest_instanced": "leaf_ibvh_nearest_kernel",
    "ray_leaves_occluded_instanced": "leaf_ibvh_occluded_kernel",
    "ray_tris_nearest": "bvh_nearest_kernel",
    "ray_tris_occluded": "bvh_occluded_kernel",
    "ray_tris_nearest_instanced": "tri_ibvh_nearest_kernel",
    "ray_tris_occluded_instanced": "tri_ibvh_occluded_kernel",
    "ray_leaves_nearest_f64": "leaf_bvh_nearest_f64_kernel",
    "ray_leaves_occluded_f64": "leaf_bvh_occluded_f64_kernel",
    "ray_leaves_nearest_instanced_f64": "leaf_ibvh_nearest_f64_kernel",
    "ray_leaves_occluded_instanced_f64": "leaf_ibvh_occluded_f64_kernel",
    "ray_tris_nearest_f64": "bvh_nearest_f64_kernel",
    "ray_tris_occluded_f64": "bvh_occluded_f64_kernel",
    "ray_tris_nearest_instanced_f64": "tri_ibvh_nearest_f64_kernel",
    "ray_tris_occluded_instanced_f64": "tri_ibvh_occluded_f64_kernel",
}
#: Cycles of the spin kernel the card runs while the host enqueues the
#: calls that ``_device_ms`` times (about 10 ms on an H100).
SPIN_CYCLES = 20_000_000
#: The fewest launches inside the c1 run whose device time is averaged.
RUN_WINDOW_MIN = 32
#: Bytes written before each launch where a kernel is timed with the L2
#: cache flushed (the H100's L2 holds 50 MB).
FLUSH_BYTES = 128 * 2**20


def bound_ms(n_bytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time (ms) the card could take: the larger of the bytes
    moved over the memory rate and the operations over the peak rate of
    their type (``PEAK_F32_FLOPS``, or ``PEAK_F64_FLOPS`` for the float64
    builds); returns (ms, "bytes" or "operations")."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / peak_flops
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def reset_launches():
    """Set every kernel's launch count to 0 (just before a main-path run)."""
    from eradiate_tpu_torch.kernels import reset_launches as reset

    reset()


def read_launches():
    """Every kernel's launch count by name (just after a main-path run)."""
    from eradiate_tpu_torch.kernels import read_launches as read

    return read()


def _c1(n_vza, layer_merge_tol=1e-3, stokes=False, surface=None, target=None):
    """BASELINE config 1; ``stokes`` asks for the Stokes integrator (render
    it in ``mono_polarized_single``); ``surface`` replaces its Lambertian
    floor and ``target`` its target at the origin."""
    from eradiate_tpu_torch import AtmosphereExperiment

    measures = {
        "type": "mdistant",
        "construct": "hplane",
        "zeniths": np.linspace(-75, 75, n_vza),
        "azimuth": 0.0,
        "id": "m",
    }
    if target is not None:
        measures["target"] = target
    return AtmosphereExperiment(
        integrator={"type": "volpath", "stokes": True} if stokes else None,
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures=measures,
        surface=surface or {"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        geometry={"type": "plane_parallel", "layer_merge_tol": layer_merge_tol},
    )


def _c4(sza=75.0, shell_merge_tol=1e-3, sun_tau_table="auto", stokes=False, atmosphere=None):
    """BASELINE config 4; ``stokes`` asks for the Stokes integrator (render
    it in ``mono_polarized_single``); ``atmosphere`` replaces its Rayleigh
    column."""
    from eradiate_tpu_torch import AtmosphereExperiment

    return AtmosphereExperiment(
        integrator={"type": "volpath", "stokes": True} if stokes else None,
        geometry={"type": "spherical_shell", "shell_merge_tol": shell_merge_tol,
                  "sun_tau_table": sun_tau_table},
        illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0),
            "azimuth": 0.0,
            "target": [0.0, 0.0, 6378.1],
            "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere=atmosphere or {"type": "molecular"},
    )


def _c2(n_vza):
    """BASELINE config 2 (``bench.py`` ``_c2``), from the port's copy of its
    factory: RPV floor, AFGL Rayleigh with a 0-2 km continental aerosol
    layer (tau 0.2 at 550 nm), SZA 30."""
    from eradiate_tpu_torch.test_tools.test_cases import create_rpv_afgl1986_continental_brfpp

    return create_rpv_afgl1986_continental_brfpp(n_vza=n_vza)


def _c2_over(n_vza, surface):
    """c2's scene (``bench.py`` ``_c2``: AFGL Rayleigh with the 0-2 km
    continental aerosol layer, sun at SZA 30) over ``surface``."""
    from eradiate_tpu_torch import AtmosphereExperiment

    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, n_vza), "azimuth": 0.0, "id": "m"},
        surface=surface,
        atmosphere=C2_ATMOSPHERE,
    )


def _c3(n_vza, ng_max=8):
    """BASELINE config 3 (``bench.py`` ``_c3``): the synthetic CKD database,
    the Sentinel-2A MSI band 4 response, a Lambertian floor of 0.2, at most
    ``ng_max`` (8) g-points a bin; render it in ``ckd_single``."""
    from eradiate_tpu_torch import AtmosphereExperiment
    from eradiate_tpu_torch.physics.absorption import make_synthetic_ckd_db

    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "srf": "sentinel_2a-msi-4",
            "id": "m",
        },
        surface={"type": "lambertian", "reflectance": 0.2},
        atmosphere={"type": "molecular",
                    "absorption_data": make_synthetic_ckd_db(base_sigma=2e-3, ng=8)},
        ckd_quad_config={"ng_max": ng_max},
    )


def _c3_gate(n_vza):
    """The c3 gates' scene (phases 25 and 31): c3 with 2 g-points a bin (14
    of its 56 rows, the same 7 bins). The gates are host-bound over the
    rows, whatever the samples; phases 27 and 36 render all 56 rows."""
    return _c3(n_vza, C3_GATE_NG)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def _bits(t):
    """A float tensor's bit patterns (so that -0.0 differs from +0.0)."""
    import torch

    bits = {torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype)
    return t if bits is None else t.view(bits)


def _time_ms(fn, reps=25):
    """Call time: the median over ``reps`` calls of ``fn`` of the CUDA events
    recorded before and after it. The stream is idle when the start event is
    recorded, so a wrapper's host time before its launch counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def window_records(prof):
    """What the analyses read of a stopped profiler: ``(kernels, own)``, each
    device record's ``(name, ms)`` and, for each ``aten::`` operator, the
    device ms of the kernels it launched itself (its self device time). Read
    from the profiler's raw records and kept on ``prof``: ``prof.events()``
    first builds an event object for each record, some 60 us a record, and
    a polarized window of 48 iterations holds ~5e5 of them. Kernels are
    tied to the operator whose correlation id they carry, and operators
    that end on another thread (asynchronous) are left out, as
    ``prof.events()`` ties and leaves them."""
    cached = getattr(prof, "_window_records", None)
    if cached is not None:
        return cached
    from torch.autograd import DeviceType

    kernels, by_op, op_names = [], {}, {}
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            ms = e.duration_ns() / 1e6
            kernels.append((e.name(), ms))
            by_op[e.linked_correlation_id()] = by_op.get(e.linked_correlation_id(), 0.0) + ms
        elif kind == DeviceType.CPU and not e.is_async() and (
                e.start_thread_id() == e.end_thread_id()):
            name = e.name()
            if name.startswith("aten::"):
                op_names[e.correlation_id()] = name
    own = {}
    for corr, name in op_names.items():
        if corr in by_op:
            own[name] = own.get(name, 0.0) + by_op[corr]
    prof._window_records = kernels, own
    return prof._window_records


def _kernel_records(prof, kernel):
    """The device times (ms) of the profiler's records of the CUDA kernel
    named ``kernel`` (the function's own name, so that ``bvh_nearest_kernel``
    is not taken for ``leaf_bvh_nearest_kernel``; demangled or not)."""
    name = re.compile(rf"(?<![A-Za-z_]){kernel}(?![a-z_])")
    return [ms for n, ms in window_records(prof)[0] if name.search(n)]


def _device_ms(fn, kernel, reps=25, flush=False, per_call=1):
    """Device time of ``fn``'s kernel ``kernel``, without the host time
    around its launch; returns (ms, by). The ``reps`` calls are enqueued
    while the card runs a spin kernel, each between two CUDA events (with
    ``flush``, after writing ``FLUSH_BYTES``, so that the kernel finds the
    L2 cache cold), so that no call waits for the host; ``torch.profiler``
    records the kernel's own durations on the same calls. ``by`` is
    "profiler": the median of those records, where the profiler kept at
    least half of them (it drops records now and then, at times most of a
    sweep's), else "events": the median of the calls' event times (the
    kernels a call launches, back to back). ``per_call``: the launches of
    ``kernel`` a call makes (a forward rule's two); the time is then the
    median record times ``per_call``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda") if flush else None
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(spin)
            spun = torch.cuda.Event()
            spun.record()
            pairs = []
            for _ in range(reps):
                if scratch is not None:
                    scratch.fill_(1.0)
                pairs.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
                pairs[-1][0].record()
                fn()
                pairs[-1][1].record()
            caught_up = spun.query()  # the card finished the spin before the last call
            torch.cuda.synchronize()
        if not caught_up:
            break
        if spin >= 64 * SPIN_CYCLES:
            raise AssertionError(f"the host could not enqueue {reps} calls of {kernel} "
                                 "within the spin")
        spin *= 4
    records = _kernel_records(prof, kernel)
    if len(records) > reps * per_call:
        raise AssertionError(f"the profiler recorded {len(records)} launches of {kernel} in "
                             f"{reps} calls")
    if len(records) >= reps * per_call // 2:
        return per_call * statistics.median(records), "profiler"
    return statistics.median(a.elapsed_time(b) for a, b in pairs), "events"


def check_collision_fetch(name, column, B, seed, timed=False, offset=0):
    """The collision-fetch kernel against its twin on the card, on ``column``
    (``(z_levels, tau_levels, tables)``, numpy) and ``B`` queries of
    ``test_tools.collision_fetch.stress_queries`` (NaN, +-inf, -0.0, every
    level and one ulp either side over the head of uniform ones); ``offset``
    1 takes them as a ``q[1:]`` view, 4 bytes past a 16-byte boundary. z,
    layer and every fetched row bit pattern for bit pattern on every lane,
    fatal on any lane that differs. Returns (max |dz| where finite, times,
    (bound ms, bound by)), the last two where ``timed``: the wrapper's call
    time, the kernel's device time and its device time with the L2 cache
    flushed before each launch, and the twin's call time. The bound: the
    queries and the tables read once, z, layer and the fetched rows written
    once; T = ceil(log2(L + 2)) comparisons and one interpolation a lane."""
    import torch

    from eradiate_tpu_torch.kernels import collision_fetch as cf
    from eradiate_tpu_torch.test_tools.collision_fetch import search_trips, stress_queries

    z_levels, tau_levels, tables = (torch.tensor(a, device="cuda") for a in column)
    q = torch.tensor(stress_queries(column[1], B + offset, seed), device="cuda")[offset:]
    args = (q, z_levels, tau_levels, tables)
    f64 = q.dtype == torch.float64
    kernel = KERNELS["collision_fetch_f64" if f64 else "collision_fetch"]
    got = cf.collision_fetch(*args)
    want = cf.collision_fetch_plain(*args)
    for label, g, w in zip(("z", "layer", "fetched"), got, want):
        differ = (_bits(g) != _bits(w)).reshape(-1, B).any(dim=0)
        if differ.any():
            raise AssertionError(f"{name}: {label} differs from the twin on "
                                 f"{int(differ.sum())} of {B} lanes")
    err = float(torch.nan_to_num((got[0] - want[0]).abs(), nan=0.0).max())
    K, L = tables.shape
    line = (f"  {name}: B={B} L={L} K={K} {q.dtype}{' from a q[1:] view' if offset else ''}: "
            f"z, layer "
            f"and fetched bit for bit on every lane, 0 lanes differ"
            + ("" if offset else f" (the NaN query: layer {int(got[1][0])}, z {float(got[0][0])})"))
    times = bound = None
    if timed:
        device, by = _device_ms(lambda: cf.collision_fetch(*args), kernel)
        flushed, flushed_by = _device_ms(lambda: cf.collision_fetch(*args), kernel, flush=True)
        times = {"ms": _time_ms(lambda: cf.collision_fetch(*args)), "device_ms": device,
                 "device_by": by, "flushed_device_ms": flushed,
                 "plain_ms": _time_ms(lambda: cf.collision_fetch_plain(*args))}
        n_bytes = sum(t.numel() * t.element_size() for t in args + tuple(got))
        bound = bound_ms(n_bytes, B * (search_trips(L) + 6),
                         PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
        line += (f"; call {times['ms']:.4f} ms (CUDA events around the wrapper), device "
                 f"{device:.4f} ms (by the {by}), with the L2 flushed between launches (128 MB "
                 f"written) {flushed:.4f} ms (by the {flushed_by}), twin "
                 f"{times['plain_ms']:.4f} ms (medians of 25), bound {bound[0]:.4f} ms by "
                 f"{bound[1]}")
    print(line, flush=True)
    return err, times, bound


def _shell_inputs(exp, B, seed, vacuum=False, device="cuda"):
    """Shell-kernel operands for ``B`` lanes of c4's first spectral row: the
    first half the lanes of a real first event (rays from the top of the
    atmosphere along the view directions), the rest seeded interior states
    (steep descents, grazing rays, tangents below the ground, isotropic),
    flight caps as the tracer computes them. ``vacuum`` zeroes every third
    shell."""
    import torch

    from eradiate_tpu_torch.ops.tracer_spherical import flight_bounds, toa_rays

    m = exp.measures[0]
    scene, sensor, _ = exp.compile_scene(m, exp.spectral_context(m))
    radii = torch.tensor(scene.medium.radii, device=device)
    sigma = np.array(scene.medium.sigma_t[0])
    if vacuum:
        sigma[::3] = 0.0
    sigma = torch.tensor(sigma, device=device)
    w_sun = -torch.tensor(scene.illumination.direction, device=device)
    rng = np.random.default_rng(seed)
    n_first = B // 2
    dirs = np.asarray(sensor.directions, np.float32)
    w_v = torch.tensor(dirs[np.arange(n_first) % len(dirs)], device=device)
    target = torch.tensor(np.asarray(sensor.target, np.float32), device=device)
    p0, d0 = toa_rays(w_v, target, radii[-1])

    n = B - n_first
    r_lo, r_hi = float(radii[0]) + 1e-3, float(radii[-1]) - 1e-3
    r = rng.uniform(r_lo, r_hi, n)
    theta, phi = rng.uniform(0, np.pi / 6, n), rng.uniform(0, 2 * np.pi, n)
    up = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    iso = rng.normal(size=(n, 3))
    iso /= np.linalg.norm(iso, axis=1, keepdims=True)
    tangent = np.cross(up, iso)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    kind = np.arange(n) % 4
    d = np.where(
        (kind == 0)[:, None], -up + 0.05 * iso,  # steep descents: tangent below ground
        np.where((kind == 1)[:, None], tangent + 1e-3 * iso,  # grazing
                 np.where((kind == 2)[:, None], -up + 0.3 * iso, iso)),
    )
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p1 = torch.tensor((up * r[:, None]).astype(np.float32), device=device)
    d1 = torch.tensor(d.astype(np.float32), device=device)

    p = torch.cat([p0, p1]).contiguous()
    d = torch.cat([d0, d1]).contiguous()
    t_ground, t_exit = flight_bounds(p, d, radii)
    t_max = torch.minimum(t_ground, t_exit).contiguous()
    u = torch.tensor(rng.uniform(0, 1, B).astype(np.float32), device=device)
    tau_s = -torch.log1p(-u)
    return p, d, t_max, radii, sigma, tau_s, w_sun.contiguous()


def _slant_start_sums(p, w, radii):
    """Where the slant sums from points ``p`` toward ``w`` start, as a
    float64 tensor on their device: (sum of the first crossed shell l0 over
    the lanes that loop, those lanes, sum of the loop starts of the warps
    that loop (the least l0 of their looping lanes), those warps, crossed
    segments, lanes)."""
    import torch

    from eradiate_tpu_torch.test_tools import shells

    L = radii.shape[0] - 1
    l0, _, blocked = shells.first_shells(p, w, radii)
    loops = ~blocked & (l0 < L)
    starts = shells.loop_starts(l0, loops, L)[:: shells.WARP]
    warps = starts < L
    return torch.stack([
        torch.where(loops, l0, 0).sum(), loops.sum(), torch.where(warps, starts, 0).sum(),
        warps.sum(), shells.crossed_segments(p, w, radii).sum(),
        torch.tensor(p.shape[0], device=p.device),
    ]).double()


def _start_means(sums):
    """(mean l0, mean warp loop start, mean crossed segments a lane, share
    of the warps that loop)."""
    from eradiate_tpu_torch.test_tools.shells import WARP

    s = sums.tolist()
    return (s[0] / max(s[1], 1), s[2] / max(s[3], 1), s[4] / max(s[5], 1),
            s[3] / max(-(-s[5] // WARP), 1))


def _slant_stress_inputs(column, w, B, seed, device="cuda", dtype=np.float32):
    """Shell-kernel operands whose slant stage sees the stresses of
    ``test_tools.shells.stress_points`` toward ``w``: no flight (t_max = 0,
    directions with negative components so that the step adds -0 and keeps
    a -0 coordinate), so that the event point is the point itself. With
    ``dtype`` float64 the stresses are made in float64 (each ulp a float64
    one)."""
    import torch

    from eradiate_tpu_torch.test_tools import shells

    radii, sigma = shells.stress_columns(np.random.default_rng(8))[column]
    p = shells.stress_points(np.random.default_rng(seed), radii, w, B, dtype=dtype)
    d = np.full((B, 3), -(3.0**-0.5), np.float32)
    ops = (p, d, np.zeros(B, np.float32), radii, sigma, np.ones(B, np.float32), w)
    return tuple(torch.tensor(np.ascontiguousarray(a, dtype), device=device) for a in ops)


def _flight_stats(args):
    """What the flights of the lanes ``args`` (the shell kernels' operands)
    visit, from the kernels' emulation (``test_tools.shells
    .shell_flight_checkpointed`` at the kernels' stride S): float sums
    {lanes, level passes a lane now and under the two sweeps before, the
    slowest lane of each warp (both counts), the most of any warp now,
    lanes that resume at the sweep's stop and that walk past it, the levels
    a flight has to read (``flight_levels``, the bound's count), L, S}."""
    from eradiate_tpu_torch.kernels.shell_flight import flight_stride
    from eradiate_tpu_torch.test_tools import shells

    p, d, t_max, radii, sigma, tau_s = args[:6]
    L = sigma.shape[0]
    S = flight_stride(L, p.dtype)
    *_, tr = shells.shell_flight_checkpointed(p, d, t_max, radii, sigma, tau_s, S)
    visits = tr["sweep"] + tr["walk"]
    parent = shells.parent_visits(tr, L)
    slowest, slowest_parent = shells.warp_max(visits), shells.warp_max(parent)
    sums = {
        "lanes": p.shape[0], "visits": visits.sum(), "parent": parent.sum(),
        "warps": slowest.shape[0], "slowest": slowest.sum(), "slowest_parent": slowest_parent.sum(),
        "most": slowest.max(), "at_stop": tr["at_end"].sum(), "past_stop": (tr["kv"] > tr["end"]).sum(),
        "levels": shells.flight_levels(tr).sum(), "L": L, "S": S,
    }
    return {k: float(v) for k, v in sums.items()}


def _flight_line(st):
    """One line of :func:`_flight_stats` (means a lane and a warp)."""
    lanes, warps = st["lanes"], st["warps"]
    return (f"flight, as the emulation counts it on these lanes: {st['visits'] / lanes:.2f} "
            f"level passes a lane ({st['parent'] / lanes:.2f} "
            f"under the two sweeps before), slowest lane of a warp {st['slowest'] / warps:.2f} "
            f"({st['slowest_parent'] / warps:.2f}), at most {st['most']:.0f} (L + S = "
            f"{st['L'] + st['S']:.0f}); resume at the sweep's stop {st['at_stop'] / lanes:.3f}, "
            f"walk past it {st['past_stop'] / lanes:.3f}; levels a flight has to read "
            f"{st['levels'] / lanes:.2f} a lane")


def check_shell_kernels(name, args, timed=False):
    """K2, K3 and K4 against their twins on the card, bitwise; returns
    ({kernel: max abs error}, {kernel: {"ms": call ms, "device_ms": device
    ms, "device_by", "plain_ms": twin ms}}, {kernel: (bound ms, bound by)}).
    K4 (slant_tau) is given the event points of K2's flight, formed as
    shell_event forms them, so its depths must also equal K3's.
    The bound: the lanes' state and the column read once, the outputs
    written once; per lane ~8 float32 operations (a square root among them)
    for each level its flight has to read, from its tangent level to the
    highest of its brackets of |x0|, |x_max| and the sampled depth
    (``test_tools.shells.flight_levels``), and, for shell_event and
    slant_tau, ~15 operations (a root and a quotient) for each distinct
    segment of the slant path from the event point: the shells from the
    first one it crosses to the top, and a descending path's partial segment
    in its point's shell (``test_tools.shells.crossed_segments``), whatever
    implements them. The bound before (two sweeps from level 0 up to the
    event's shell, 8 x 2 x (layer + 1) operations) is printed beside it.
    Fails where a lane passes more than L + S levels in the kernels'
    emulation (``_flight_stats``)."""
    import torch

    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import fma
    from eradiate_tpu_torch.test_tools.shells import crossed_segments

    p, d, t_max, radii, sigma, _, w_sun = args
    flight_args = args[:6]
    flight = _flight_stats(args)
    if flight["most"] > flight["L"] + flight["S"]:
        raise AssertionError(f"{name}: an emulated lane passes {flight['most']:.0f} levels, "
                             "above L + S")
    collide, t_col, _ = sf.shell_flight(*flight_args)
    p_event = fma(d, torch.where(collide, t_col, t_max)[:, None], p).contiguous()
    segments = crossed_segments(p_event, w_sun, radii)
    mean_l0, mean_start, mean_segments, looping = _start_means(
        _slant_start_sums(p_event, w_sun, radii))
    checks = {
        "shell_flight": (sf.shell_flight, sf.shell_flight_plain, flight_args),
        "slant_tau": (lambda *a: (sf.slant_tau(*a),), lambda *a: (sf.slant_tau_exact(*a),),
                      (p_event, w_sun, radii, sigma)),
        "shell_event": (sf.shell_event, sf.shell_event_plain, args),
    }
    errs, times, bounds, bounds_before = {}, {}, {}, {}
    for kernel, (fn, plain, a) in checks.items():
        got, want = fn(*a), plain(*a)
        labels = ("tau",) if kernel == "slant_tau" else ("collide", "t_col", "layer", "tau_sun")
        for label, g, w in zip(labels, got, want):
            if not torch.equal(_bits(g), _bits(w)):
                gn, wn = g.cpu().numpy(), w.cpu().numpy()
                detail = f"{int((_bits(g) != _bits(w)).sum())} lanes"
                if gn.dtype == np.float32:
                    detail += f", max {int(_ulps(gn, wn).max())} ulp"
                raise AssertionError(f"{name}: {kernel} {label} differs from the twin: {detail}")
        errs[kernel] = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        if timed:
            device, by = _device_ms(lambda: fn(*a), KERNELS[kernel])
            times[kernel] = {"ms": _time_ms(lambda: fn(*a)), "device_ms": device,
                             "device_by": by, "plain_ms": _time_ms(lambda: plain(*a), reps=5)}
            n_bytes = sum(t.numel() * t.element_size() for t in tuple(a) + tuple(got))
            flops = before = 40.0 * a[0].shape[0]
            if kernel != "slant_tau":
                flops += 8.0 * flight["levels"]
                before += 8.0 * 2.0 * float((got[2].double() + 1.0).sum())
            if kernel != "shell_flight":
                flops += 15.0 * float(segments.sum())
                before += 15.0 * float(segments.sum())
            bounds[kernel] = bound_ms(n_bytes, flops)
            bounds_before[kernel] = bound_ms(n_bytes, before)[0]
        if kernel == "slant_tau":
            tau_k4 = got[0]
    if not torch.equal(_bits(tau_k4), _bits(got[3])):
        raise AssertionError(f"{name}: slant_tau at the event points differs from shell_event")
    collide = got[0].float().mean().item()
    blocked = (got[3] >= 1e9).float().mean().item()
    line = (f"  {name}: B={args[0].shape[0]} L={args[4].shape[0]} collide, t_col, "
            f"layer, tau_sun, tau bitwise for the three kernels (0 lanes differ), "
            f"slant_tau equal to shell_event's (collide share {collide:.3f}, TAU_BLOCKED "
            f"share {blocked:.3f}); slant from the event points: first crossed shell l0 "
            f"mean {mean_l0:.2f}, warp loop start (least l0 of a warp) mean "
            f"{mean_start:.2f}, crossed segments a lane {mean_segments:.2f}, warps that loop "
            f"{looping:.3f}; " + _flight_line(flight))
    for kernel, t in times.items():
        line += (f"; {kernel} kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} by the "
                 f"{t['device_by']}), twin "
                 f"{t['plain_ms']:.4f} ms, bound {bounds[kernel][0]:.4f} ms by "
                 f"{bounds[kernel][1]}")
        if kernel != "slant_tau":
            line += f" ({bounds_before[kernel]:.4f} ms under the two sweeps' count)"
    print(line, flush=True)
    return errs, times, bounds


#: Operands made by :func:`_flight_stress_inputs`, by their arguments: the
#: phases that check the same stresses (7, 33 and L) make them once.
_FLIGHT_STRESS = {}


def _flight_stress_inputs(radii, sigma, w, B, seed, device="cuda", dtype=np.float32):
    """Shell-kernel operands on the flight's stresses of ``test_tools.shells
    .flight_stress_inputs`` for the column ``radii``, ``sigma``, the slant
    stage toward ``w``; with ``dtype`` float64 made in float64 (each tie and
    ulp a float64 one). Made once for each set of arguments (the making, on
    the host, takes seconds a column: longer than the checks)."""
    key = tuple(np.asarray(a, dtype).tobytes() for a in (radii, sigma, w)) + (
        B, seed, device, np.dtype(dtype).str)
    if key not in _FLIGHT_STRESS:
        _FLIGHT_STRESS[key] = _make_flight_stress_inputs(radii, sigma, w, B, seed, device,
                                                         dtype)
    return _FLIGHT_STRESS[key]


def _make_flight_stress_inputs(radii, sigma, w, B, seed, device, dtype):
    import torch

    from eradiate_tpu_torch.test_tools import shells

    radii, sigma = (np.asarray(a, dtype) for a in (radii, sigma))
    p, d, t_max, tau_s = shells.flight_stress_inputs(np.random.default_rng(seed), radii, sigma,
                                                     B, device=device, dtype=dtype)
    column = (torch.tensor(np.asarray(a, dtype), device=device) for a in (radii, sigma, w))
    radii_t, sigma_t, w_t = column
    return p, d, t_max, radii_t, sigma_t, tau_s, w_t


def check_flight_root():
    """The flight loop's square root (``root_rn``: the IEEE square root's fast
    path without its range check) against ``sqrtf`` on every float32 of its
    range, bit for bit, on the card."""
    from eradiate_tpu_torch.kernels import shell_flight as sf

    t0 = time.perf_counter()
    differ = sf.flight_root_differences()
    lo, hi = sf.ROOT_RANGE
    print(f"  the flight loop's square root (root_rn) against sqrtf: every float32 from "
          f"{hex(lo)} to {hex(hi)} ({hi - lo + 1} values), {differ} differ "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    if differ:
        raise AssertionError("the flight loop's square root differs from sqrtf")


def check_slant_division():
    """The slant loop's division (``div_rn``) against numpy's IEEE float32
    division on ``test_tools.shells.division_operands``, bit for bit."""
    import torch

    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.test_tools import shells

    n, d = shells.division_operands(np.random.default_rng(3))
    got = sf.slant_division(torch.tensor(n, device="cuda"), torch.tensor(d, device="cuda"))
    differ = int((got.cpu().numpy().view(np.int32) != (n / d).view(np.int32)).sum())
    print(f"  the slant loop's division (div_rn) against the IEEE division: {n.size} operand "
          f"pairs, every divisor significand in [1, 2) among them; {differ} differ", flush=True)
    if differ:
        raise AssertionError("the slant loop's division differs from the IEEE division")


#: The launch of a flight kernel inside a run whose lanes are kept for
#: their flight statistics (the eighth: a mix of first and later events).
CAPTURE_AT = 8


def launch_ms_in_run(run, names, starts=True):
    """Call ``run()`` with the spherical tracer's kernel wrappers ``names``
    timed by CUDA events around each call (device time, nothing
    synchronised inside the run); returns ({name: (launches, mean ms a
    launch)} for the wrappers it called, the ``_slant_start_sums`` of the
    slant paths the run summed, or None where it summed none or not
    ``starts``, and the operands of the flight kernel's ``CAPTURE_AT``-th
    launch, or of its last where there were fewer, or None where it made
    none or not ``starts``), the sums taken on the device after each
    launch's end event, and only the ``CAPTURE_AT``-th launch's operands
    copied (earlier ones held by reference)."""
    import torch

    from eradiate_tpu_torch.ops import tracer_spherical as ts
    from eradiate_tpu_torch.ops.spherical import fma

    events = {n: [] for n in names}
    saved = {n: getattr(ts, n) for n in names}
    sums = []
    captured = []

    def timed(name, fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events[name].append((start, end))
            if starts and name in ("shell_flight", "shell_event"):
                # the operands of launches before CAPTURE_AT by reference,
                # that launch's copied (the tracer may reuse its buffers)
                if len(events[name]) < CAPTURE_AT:
                    captured[:] = args[:6]
                elif len(events[name]) == CAPTURE_AT:
                    captured[:] = [a.clone() for a in args[:6]]
            if starts and name == "slant_tau":
                sums.append(_slant_start_sums(args[0], args[1], args[2]))
            elif starts and name == "shell_event":
                p, d, t_max, radii, _, _, w = args
                t = torch.where(out[0], out[1], t_max)[:, None]
                sums.append(_slant_start_sums(fma(d, t, p), w, radii))
            return out
        return call

    for n in names:
        setattr(ts, n, timed(n, saved[n]))
    try:
        run()
    finally:
        for n, fn in saved.items():
            setattr(ts, n, fn)
    torch.cuda.synchronize()
    out = {n: (len(ev), statistics.fmean(a.elapsed_time(b) for a, b in ev))
           for n, ev in events.items() if ev}
    return out, torch.stack(sums).sum(0) if sums else None, tuple(captured) or None


class _WindowClosed(Exception):
    """Raised inside a run to end it once its profiler window has closed."""


def profile_window(run, module, attr, skip, window):
    """Call ``run()`` with ``module.attr``, a function the loop calls once a
    bounce iteration, wrapped so that ``torch.profiler`` records a window of
    ``window`` iterations after the first ``skip`` (started before the
    window's first call, stopped after a synchronise after its last), and
    end the run there: the window is all the run is for. Returns the
    profiler; fails where the run made fewer calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    saved = getattr(module, attr)
    calls = [0]

    def call(*args, **kwargs):
        if calls[0] == skip:
            prof.start()
        out = saved(*args, **kwargs)
        calls[0] += 1
        if calls[0] == skip + window:
            torch.cuda.synchronize()
            prof.stop()
            raise _WindowClosed
        return out

    setattr(module, attr, call)
    try:
        run()
    except _WindowClosed:
        pass
    finally:
        setattr(module, attr, saved)
    if calls[0] < skip + window:
        raise AssertionError(f"the run called {attr} {calls[0]} times, fewer than "
                             f"{skip + window}")
    return prof


#: Families of CUDA kernels in a profiler window, by a word of their names
#: (the port's own kernels by their names in ``KERNELS``).
KERNEL_FAMILIES = (("element-wise", "elementwise"), ("reduction", "reduce"),
                   ("sort", "sort"), ("indexing", "index"), ("gather", "gather"),
                   ("scatter", "scatter"), ("stack and cat", "cat"))


def window_device(prof, window):
    """(CUDA kernels, device ms) an iteration in a profiler window of
    ``window`` iterations: the records of every CUDA kernel, their durations
    summed (one stream: no overlap); and the window's device time by kernel
    family (the port's kernels, PyTorch's element-wise kernels,
    reductions, sorts, indexing, copies), as shares."""
    ours = tuple(KERNELS.values())
    families = {}
    # names are matched lower-cased: torch.stack and torch.cat launch
    # CatArrayBatchedCopy
    total = count = 0
    for name, ms in window_records(prof)[0]:
        total, count = total + ms, count + 1
        family = "the port's kernels" if any(k in name for k in ours) else next(
            (f for f, word in KERNEL_FAMILIES if word in name.lower()), "other")
        families[family] = families.get(family, 0.0) + ms
    shares = {f: ms / total for f, ms in sorted(families.items(), key=lambda x: -x[1])}
    return count / window, total / window, shares


def kernel_ms_in_window(prof, kernel, launches_min):
    """Mean device ms of ``kernel``'s records in a profiler window; fails
    where the profiler kept fewer than ``launches_min`` of them. Returns
    (records, ms)."""
    times = _kernel_records(prof, kernel)
    if len(times) < launches_min:
        raise AssertionError(f"the profiler recorded {len(times)} launches of {kernel}, fewer "
                             f"than {launches_min}")
    return len(times), statistics.fmean(times)


def fetch_device_ms_in_run(run, skip=100, window=48):
    """Call ``run()`` with the plane-parallel tracer's collision fetch
    profiled over a window of ``window`` launches after the first ``skip``;
    returns (launches in the window, mean device
    time a launch in ms) from the records of the kernel (the profiler drops
    a record now and then; fails where it kept fewer than
    ``RUN_WINDOW_MIN``). The kernel's durations do not count the host time
    around each launch, which the loop spends while the stream is idle."""
    from eradiate_tpu_torch.ops import tracer

    prof = profile_window(run, tracer, "collision_fetch", skip, window)
    n, ms = kernel_ms_in_window(prof, KERNELS["collision_fetch"], RUN_WINDOW_MIN)
    if n > window:
        raise AssertionError(f"the profiler recorded {n} of the window's {window} "
                             "collision fetches")
    return n, ms


def _print_in_run(in_run, sums=None, lanes=None):
    line = ("    device time a launch inside the run (CUDA events around each launch, "
            "one more run): " + ", ".join(f"{n} {ms:.4f} ms over {k} launches"
                                          for n, (k, ms) in in_run.items()))
    if sums is not None:
        line += ("; slant paths from its event points: first crossed shell l0 mean "
                 "{:.2f}, warp loop start mean {:.2f}, crossed segments a lane {:.2f}, warps "
                 "that loop {:.3f}").format(*_start_means(sums))
    if lanes is not None:
        line += f"; the lanes of launch {CAPTURE_AT}: " + _flight_line(_flight_stats(lanes))
    print(line, flush=True)


def c4_cuda_vs_cpu(sza, phase=8, label="c4", atmosphere=None):
    """Phase 8 for one sun zenith (phase D: c4 under ``atmosphere``); returns
    the CUDA run's launches."""
    import eradiate_tpu_torch as etp

    out = {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        out[dev] = etp.run(_c4(sza, atmosphere=atmosphere), spp=256,
                           seed_state=etp.SeedState(SEED), device=dev)
        if dev == "cuda":
            launches = read_launches()
    brf_g, brf_c = (np.asarray(out[d]["brf"]) for d in ("cuda", "cpu"))
    rad_g, rad_c = (np.asarray(out[d]["radiance"]) for d in ("cuda", "cpu"))
    var = np.asarray(out["cuda"]["var"]) + np.asarray(out["cpu"]["var"])
    rel = np.abs(brf_g - brf_c) / np.abs(brf_c)
    zmax = float(np.max(np.abs(rad_g - rad_c) / np.sqrt(var)))
    print(f"[{phase}] {label} SZA {sza:g}, 15 VZA 256 spp, CUDA vs CPU: max rel BRF diff "
          f"{rel.max():.3e} (bound 5e-2), median {np.median(rel):.3e} (bound 1e-4), "
          f"pixels above 1e-4: {int((rel > 1e-4).sum())}, max |z| {zmax:.3e} "
          f"(bound 5)", flush=True)
    if not (np.isfinite(brf_g).all() and rel.max() <= 5e-2 and np.median(rel) <= 1e-4
            and zmax <= 5.0):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on {label} at SZA {sza:g}")
    return launches


def c4_full_width(sza, spp, phase):
    """Phases 9 and 10: one timed run of c4 at ``spp``; returns the launch
    counts of the run by kernel, the shell kernels' device time a launch in
    one more run (``launch_ms_in_run``), and the BRF at VZA -5."""
    import torch

    import eradiate_tpu_torch as etp

    exp = _c4(sza)
    etp.run(exp, spp=spp if phase == 9 else 4096, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    brf = np.asarray(ds["brf"])
    samples = N_VZA_C4 * spp
    print(f"[{phase}] c4 SZA {sza:g} full width: {N_VZA_C4} VZA x {spp} spp = {samples} "
          f"samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, "
          f"{iterations} event iterations ({1e3 * wall / iterations:.3f} ms each), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    launches {launches}; BRF finite {bool(np.isfinite(brf).all())}, shape "
          f"{brf.shape}, BRF at VZA -5: {brf[0, 8]:.6f}", flush=True)
    kernel = "shell_flight" if sza <= 80.0 else "shell_event"
    others = [k for k in launches if k != kernel]
    if not (launches[kernel] > 0 and launches[kernel] == iterations):
        raise AssertionError(f"c4 at SZA {sza:g} did not launch {kernel} once per event")
    if any(launches[k] for k in others):
        raise AssertionError(f"c4 at SZA {sza:g} launched {others}")
    if brf.shape != (1, N_VZA_C4) or not np.isfinite(brf).all():
        raise AssertionError("c4 BRF is not finite or has the wrong shape")
    in_run, sums, lanes = launch_ms_in_run(
        lambda: etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda"), (kernel,))
    _print_in_run(in_run, sums, lanes)
    return launches, in_run, float(brf[0, 8])


def _wood_obj(directory, branches=WOOD_BRANCHES):
    """Write the wood skeleton of one HET01 tree (a 10 m trunk and
    ``branches`` branches of 4.5 m from the crown's centre, 36 + 24 x branches
    triangles, metres; seed 7) as an OBJ file under ``directory``, once;
    returns its path."""
    from eradiate_tpu_torch.test_tools.meshes import wood_skeleton, write_obj

    path = Path(directory) / f"wood_{branches}.obj"
    if not path.exists():
        write_obj(path, *wood_skeleton(np.random.default_rng(7), n_branches=branches))
    return str(path)


def _c5(form="instanced", mesh_dir=None, branches=WOOD_BRANCHES, stokes=False, variant=None):
    """The scene of BASELINE config 5 (``bench.py`` ``_c5``) with the scalar
    integrator (with ``stokes``, config 5 as ``bench.py`` builds it: render
    it in ``mono_polarized_single``), in one of four forms:

    - ``instanced``: HET01's leaf cloud instanced at its 15 positions;
    - ``flat``: the same canopy as two elements (positions split 8 + 7),
      which the experiment flattens;
    - ``trees``: one abstract tree (HET01's crown on a 6 m trunk of 0.25 m
      radius, reflectance 0.125) instanced at the 15 positions: instanced
      leaves and instanced trunk triangles;
    - ``wood``: HET01's leaf cloud and a mesh tree (the wood skeleton of
      :func:`_wood_obj` with ``branches`` branches, written to and read back
      from ``mesh_dir``), both at the 15 positions: two elements, flattened
      to 30000 disks and, with 256 branches, 92700 triangles.

    ``variant`` (phase D): ``checkerboard`` or ``central_patch`` replace the
    Lambertian floor by :data:`C5_GROUNDS`' textured grounds, ``aerosol``
    the Rayleigh column by c2's atmosphere with its aerosol layer; (phase H)
    ``spot`` lights the scene by :func:`_spot` and sees it by a 128 x 128
    box camera (:data:`H_CAMERA`), ``spot_gate`` by an 8 x 8 one.
    """
    from eradiate_tpu_torch import CanopyAtmosphereExperiment
    from eradiate_tpu_torch.scenes.biosphere import DiscreteCanopy, LeafCloud
    from eradiate_tpu_torch.test_tools.test_cases import create_het01_brfpp

    el = create_het01_brfpp(n_vza=N_VZA_C5).canopy.instanced_canopy_elements[0]
    pos = np.atleast_2d(el.instance_positions)
    if form == "instanced":
        elements = [(el.canopy_element, pos)]
    elif form == "flat":
        elements = [(el.canopy_element, pos[:8]), (el.canopy_element, pos[8:])]
    elif form == "trees":
        crown = LeafCloud.sphere(
            n_leaves=2000, leaf_radius=0.1, radius=5.0, center=(0.0, 0.0, 4.0),
            leaf_reflectance=0.4957, leaf_transmittance=0.4409,
        )
        tree = {"type": "abstract_tree", "leaf_cloud": crown, "trunk_height": 6.0,
                "trunk_radius": 0.25, "trunk_reflectance": 0.125}
        elements = [(tree, pos)]
    elif form == "wood":
        wood = {"type": "mesh_tree", "mesh_tree_elements": [
            {"mesh_filename": _wood_obj(mesh_dir, branches), "mesh_units": "m",
             "reflectance": 0.125, "transmittance": 0.0}]}
        elements = [(el.canopy_element, pos), (wood, pos)]
    else:
        raise ValueError(f"unknown form {form!r}")
    return CanopyAtmosphereExperiment(
        canopy=DiscreteCanopy(
            size=(100.0, 100.0, 15.0),
            instanced_canopy_elements=[
                {"type": "instanced", "canopy_element": e, "instance_positions": part}
                for e, part in elements
            ],
        ),
        atmosphere=(C2_ATMOSPHERE if variant == "aerosol"
                    else {"type": "molecular", "has_absorption": False}),
        illumination=(_spot() if variant in ("spot", "spot_gate")
                      else {"type": "directional", "zenith": 20.0, "azimuth": 0.0}),
        measures=(
            {**H_CAMERA, "film_resolution": (128, 128) if variant == "spot" else (8, 8)}
            if variant in ("spot", "spot_gate") else {
                "type": "mdistant",
                "construct": "hplane",
                "zeniths": np.linspace(-75, 75, N_VZA_C5),
                "azimuth": 0.0,
                "id": "m",
            }),
        surface=C5_GROUNDS.get(variant, {"type": "lambertian", "reflectance": 0.159}),
        integrator={"type": "volpath", "stokes": stokes},
    )


def _canopy_rays(exp, scene, sensor, lo_n, hi_n, B, seed, miss=False):
    """``B`` rays of the c5 scene as float64 numpy ``(p, d, t_max)``: a third
    from the top of the atmosphere along the view directions toward the
    jittered footprint, a third from inside a crown in random directions, a
    third shadow rays toward the sun from random points of the box ``lo_n``,
    ``hi_n`` (``miss``: every ray passes beside the box)."""
    rng = np.random.default_rng(seed)
    n0, n1 = B // 3, B // 3
    n2 = B - n0 - n1

    dirs = np.asarray(sensor.directions, np.float32)
    w_v = dirs[np.arange(n0) % len(dirs)]
    ext = np.asarray(sensor.target_extent, np.float64)
    tgt = np.asarray(sensor.target, np.float64) + np.concatenate(
        [(rng.uniform(0, 1, (n0, 2)) - 0.5) * ext, np.zeros((n0, 1))], axis=1
    )
    t_up = (float(scene.medium.z_levels[-1]) - tgt[:, 2]) / np.maximum(w_v[:, 2], 1e-6)
    p0, d0 = tgt + w_v * t_up[:, None], -w_v
    t0 = t_up + rng.uniform(0.0, 0.03, n0)  # down to about the ground

    offsets = np.concatenate(
        [np.atleast_2d(el.instance_positions) for el in exp.canopy.instanced_canopy_elements]
    )
    v = rng.normal(size=(n1, 3))
    v *= (5e-3 * rng.uniform(0, 1, (n1, 1)) ** (1 / 3)) / np.linalg.norm(v, axis=1, keepdims=True)
    p1 = offsets[rng.integers(0, len(offsets), n1)] + [0.0, 0.0, 1e-2] + v
    d1 = rng.normal(size=(n1, 3))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    t1 = rng.uniform(1e-4, 5e-2, n1)

    p2 = rng.uniform(lo_n, hi_n, (n2, 3))
    d2 = np.tile(-np.asarray(scene.illumination.direction, np.float64), (n2, 1))
    t2 = np.full(n2, 1e6)

    p = np.concatenate([p0, p1, p2])
    if miss:
        p[:, 0] += 1.0  # a kilometre beside the canopy
    return p, np.concatenate([d0, d1, d2]), np.concatenate([t0, t1, t2])


def _clipped(rays, lo, hi, device="cuda", dtype=np.float32):
    """Rays clipped to the box as the tracer clips them, then sorted by the
    tracer's Morton code: ``(p, d, t_cap)`` in ``dtype`` on ``device``."""
    import torch

    from eradiate_tpu_torch.ops.canopy import _advance_to_aabb
    from eradiate_tpu_torch.ops.tracer_canopy import _morton_u32

    p, d, t_max = (torch.tensor(np.asarray(a, dtype), device=device) for a in rays)
    p_adv, _, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    order = torch.argsort(_morton_u32(p_adv, lo, hi), stable=True)
    return p_adv[order].contiguous(), d[order].contiguous(), t_cap[order]


def _canopy_inputs(exp, B, seed, miss=False, device="cuda"):
    """Sweep operands for ``B`` lanes of a form of the c5 scene (the rays of
    :func:`_canopy_rays`, clipped to the box of the leaves and to the box of
    the triangles, as the tracer does): returns ``(leaves, leaf cull operand,
    leaf rays, tris, triangle cull operand, triangle rays)``, the last three
    None for a canopy without triangles; the cull operands are
    ``leaf_accel``'s (the hierarchy of a flat table, the two-level one of
    an instanced set) and ``tri_accel``'s (the hierarchy of a flat soup,
    the two-level one of an instanced soup). The operands take the dtype
    the experiment compiles in (float64 in a double mode)."""
    key = (id(exp), device)
    if _CANOPY.get(key, (None,))[0] is not exp:
        _CANOPY[key] = (exp, _canopy_compiled(exp, device))
    scene, sensor, dt, leaves, leaf_cull, lo, hi, tris, tri_cull, tri_lo, tri_hi = _CANOPY[key][1]
    rays = _canopy_rays(exp, scene, sensor, lo.cpu().numpy(), hi.cpu().numpy(), B, seed, miss)
    out = (leaves, leaf_cull, _clipped(rays, lo, hi, device, dt))
    if tris is None:
        return (*out, None, None, None)
    return (*out, tris, tri_cull, _clipped(rays, tri_lo, tri_hi, device, dt))


#: What :func:`_canopy_inputs` compiles and builds of an experiment, by its
#: id and device (with the experiment, so that a reused id is told apart):
#: the checks that take several ray sets of one form compile it once.
_CANOPY = {}


def _canopy_compiled(exp, device):
    """The compiled scene, the leaves and triangles on ``device`` and their
    hierarchies (:func:`_canopy_inputs`)."""
    from eradiate_tpu_torch.ops.canopy import leaf_accel
    from eradiate_tpu_torch.ops.mesh import tri_accel
    from eradiate_tpu_torch.ops.scene_state import canopy_from_reference, scene_dtype

    m = exp.measures[0]
    scene, sensor, _, leaf_params, leaves, tris, tri_params = exp.compile_canopy_scene(
        m, exp.spectral_context(m)
    )
    dt = scene_dtype(scene.medium)
    leaves, _, tris, _ = canopy_from_reference(leaves, leaf_params, device, tris, tri_params, dt)
    leaf_cull, lo, hi = leaf_accel(leaves)
    tri_cull = tri_lo = tri_hi = None
    if tris is not None:
        tri_cull, tri_lo, tri_hi = tri_accel(tris)
    return scene, sensor, dt, leaves, leaf_cull, lo, hi, tris, tri_cull, tri_lo, tri_hi


def _disk_inputs(table, rays, offsets=None, dtype=np.float32):
    """Leaves (flat, or instanced at ``offsets``), their kernels' hierarchy
    (one level, or two) and the rays, on the card, in ``dtype``."""
    import torch

    from eradiate_tpu_torch.kernels.leaf_intersect import leaf_bvh, leaf_instanced_bvh
    from eradiate_tpu_torch.ops.canopy import InstancedLeafArrays, LeafCloudArrays

    to_dev = lambda a: torch.tensor(np.asarray(a, dtype), device="cuda")  # noqa: E731
    cloud = LeafCloudArrays(*(to_dev(a) for a in table))
    if offsets is None:
        return cloud, leaf_bvh(cloud.centers, cloud.normals, cloud.radii), tuple(map(to_dev, rays))
    leaves = InstancedLeafArrays(cloud, to_dev(offsets))
    ibvh = leaf_instanced_bvh(cloud.centers, cloud.normals, cloud.radii, leaves.offsets)
    return leaves, ibvh, tuple(map(to_dev, rays))


def _rim_inputs(instanced, B, seed, far=False, zero_normals=False, dtype=np.float32):
    """A synthetic stress of the kernels' culls (``test_tools.disks``): 1000
    random disks (radii 0.05 to 0.2 in a box of side 2, at three offsets
    when ``instanced``; ``zero_normals``: every normal with components of
    exactly +-0) and rays aimed at points on, just inside and just outside
    their rims from 0.5-3 units (``far``: 100x farther), with caps that end
    on, just before and just behind the rim point; in ``dtype``. Returns
    ``(leaves, cull operand, (p, d, t_cap))``."""
    from eradiate_tpu_torch.test_tools import disks

    rng = np.random.default_rng(seed)
    c, n, r = disks.random_disks(rng, 1000)
    if zero_normals:
        n = disks.zero_normal_disks(rng, n, share=1.0)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]]) if instanced else None
    rays = disks.rim_rays(rng, B, c, n, r, offsets, 100.0 if far else 1.0, dtype=dtype)
    return _disk_inputs((c, n, r), rays, offsets, dtype)


def _leaf_stress_inputs(kind, B, seed, dtype=np.float32):
    """Stresses of the flat leaf kernels' hierarchy (``test_tools.disks``).
    ``"ties"``: 600 disks with coincident copies of opposite normal inside
    one 512-disk chunk and across two, the copy across with the larger box,
    so that the traversal meets the higher chunk first, and rays at the
    originals; ``"axes near"``/``"axes far"``: 1000 random disks and rays
    with direction components exactly +-0 along the planes of the disks' box
    faces, from 0.5-3 or 50-300 units; ``"grazing"``: rays that meet the
    disks at 1e-2 to 1e-5 of a right angle. In float64 (``dtype``) the tie
    table is the instanced one's canonical cloud (it also holds three- and
    four-way ties, whose float64 normals sum in index order) and its rays.
    Returns ``(leaves, hierarchy, (p, d, t_cap))``."""
    from eradiate_tpu_torch.test_tools import disks

    rng = np.random.default_rng(seed)
    if kind == "ties" and dtype == np.float64:
        table, _, rays = disks.instanced_tie_disks(rng, B, dtype=dtype)
    elif kind == "ties":
        table, rays = disks.tie_disks(rng, B)
    else:
        table = disks.random_disks(rng, 1000)
        make = disks.grazing_rays if kind == "grazing" else disks.axis_rays
        rays = make(rng, B, *table, distance=100.0 if kind.endswith("far") else 1.0,
                    dtype=dtype)
    return _disk_inputs(table, rays, dtype=dtype)


def _instanced_stress_inputs(kind, B, seed, dtype=np.float32):
    """Stresses of the instanced leaf kernels' two-level hierarchy
    (``test_tools.disks``). ``"ties"``: the instanced tie table (600 disks
    at three offsets along x, with exact ties inside a chunk, across two,
    across instances with opposite normals, where the lower instance wins
    from a higher chunk, and four coincident disks with normals n, n, n,
    -n) and rays at its tied disks; ``"axes near"``/``"axes far"`` and
    ``"grazing"``: 1000 random disks at three offsets and the rays of
    ``axis_rays`` or ``grazing_rays`` in their frames; ``"far offsets"``:
    1000 random disks at three offsets 200 units (100x the cloud's size)
    from the world origin, and rays at their rims from origins within a
    unit of the world origin; in ``dtype``. Returns ``(leaves, hierarchy,
    (p, d, t_cap))``."""
    from eradiate_tpu_torch.test_tools import disks

    rng = np.random.default_rng(seed)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]])
    if kind == "ties":
        table, offsets, rays = disks.instanced_tie_disks(rng, B, dtype=dtype)
        return _disk_inputs(table, rays, offsets, dtype)
    table = disks.random_disks(rng, 1000)
    if kind == "far offsets":
        offsets = np.array([[200.0, 0, 0], [0, -200.0, 0], [140.0, 140.0, 30.0]])
        rays = disks.rim_rays(rng, B, *table, offsets, origins=rng.uniform(-1, 1, (B, 3)),
                              dtype=dtype)
    elif kind == "grazing":
        rays = disks.grazing_rays(rng, B, *table, offsets=offsets, dtype=dtype)
    else:
        rays = disks.axis_rays(rng, B, *table, 100.0 if kind.endswith("far") else 1.0,
                               offsets, dtype=dtype)
    return _disk_inputs(table, rays, offsets, dtype)


def _edge_inputs(instanced, B, seed, far, device="cuda", dtype=np.float32, vertices=False):
    """A stress of the triangle kernels' exact test and culls: the wood
    skeleton (closed cylinders, 6180 triangles, at three offsets when
    ``instanced``) and rays aimed at its shared edges, at its vertices, at
    interior points and just beside edges, from 0.5-3 m away (``far``: from
    50-300 m, 100x farther), with caps that end on, just before and just
    behind the target; with ``vertices``, rays aimed exactly at its
    vertices, half along an axis (``test_tools.meshes.vertex_rays``: a cap's
    apex joins twelve triangles, a side vertex up to six). In ``dtype``.
    Returns ``(tris, cull operand, (p, d, t_cap))``: the two-level hierarchy
    of the instanced kernels or the flat ones'."""
    import torch

    from eradiate_tpu_torch.kernels.tri_intersect import tri_bvh, tri_instanced_bvh
    from eradiate_tpu_torch.ops.mesh import (
        InstancedTriArrays,
        TriangleMeshArrays,
        mesh_from_vertices,
    )
    from eradiate_tpu_torch.test_tools.meshes import edge_rays, vertex_rays, wood_skeleton

    v, f = wood_skeleton(np.random.default_rng(7), n_branches=WOOD_BRANCHES)
    soup = mesh_from_vertices((v * 1e-3).astype(dtype), f)
    offsets = np.array([[0.0, 0, 0], [0.02, 0, 0], [0, 0.03, 0]]) if instanced else None
    rng = np.random.default_rng(seed)
    if vertices:
        verts = v * 1e-3 if offsets is None else np.concatenate([v * 1e-3 + o for o in offsets])
        rays = vertex_rays(rng, B, verts, 1e-3 if far else 1e-5, dtype=dtype)
    else:
        rays = edge_rays(rng, B, soup, offsets, 1e-3 if far else 1e-5, dtype=dtype)
    to_dev = lambda a: torch.tensor(np.asarray(a, dtype), device=device)  # noqa: E731
    tris = TriangleMeshArrays(to_dev(soup.v0), to_dev(soup.e1), to_dev(soup.e2))
    if instanced:
        tris = InstancedTriArrays(tris, to_dev(offsets))
        cull = tri_instanced_bvh(tris.canonical.v0, tris.canonical.e1, tris.canonical.e2,
                                 tris.offsets)
    else:
        cull = tri_bvh(tris.v0, tris.e1, tris.e2)
    return tris, cull, tuple(to_dev(a) for a in rays)


def _flat_stress_inputs(kind, B, seed, device="cuda", dtype=np.float32):
    """Stresses of the flat kernels' hierarchy. ``"ties"``: the soup of
    ``test_tools.meshes.tie_soup`` (600 triangles with scaled copies and
    exact duplicates inside one 512-triangle chunk and across two, the copy
    at the higher index and with the larger box, so that the traversal meets
    it first) and rays at the originals; ``"axes near"``/``"axes far"``: the
    wood skeleton and rays of ``axis_rays`` from 0.5-3 m or 50-300 m, with
    direction components exactly +-0 and the zero components of the origin
    on the planes of vertices. In ``dtype``. Returns ``(tris, hierarchy, (p, d,
    t_cap))``."""
    import torch

    from eradiate_tpu_torch.kernels.tri_intersect import tri_bvh
    from eradiate_tpu_torch.ops.mesh import TriangleMeshArrays, mesh_from_vertices
    from eradiate_tpu_torch.test_tools.meshes import axis_rays, tie_soup, wood_skeleton

    rng = np.random.default_rng(seed)
    if kind == "ties":
        arrays, rays = tie_soup(rng, B, dtype=dtype)
    else:
        v, f = wood_skeleton(np.random.default_rng(7), n_branches=WOOD_BRANCHES)
        soup = mesh_from_vertices((v * 1e-3).astype(dtype), f)
        arrays = (soup.v0, soup.e1, soup.e2)
        rays = axis_rays(rng, B, soup, 1e-3 if kind.endswith("far") else 1e-5, dtype=dtype)
    to_dev = lambda a: torch.tensor(np.ascontiguousarray(a, dtype), device=device)  # noqa: E731
    tris = TriangleMeshArrays(*(to_dev(a) for a in arrays))
    return tris, tri_bvh(tris.v0, tris.e1, tris.e2), tuple(to_dev(a) for a in rays)


def _instanced_tri_stress_inputs(kind, B, seed, trunks=None, dtype=np.float32):
    """Stresses of the instanced triangle kernels' two-level hierarchy
    (``test_tools.meshes``). ``"ties"``: the instanced tie soup (600
    triangles at nine offsets, three at each: exact ties inside a chunk,
    across two, and across instances, where the lowest instance wins from a
    higher chunk and from a lower one after the walk, nearer first, has met
    a higher instance) and rays at its tied triangles; the others on the
    trunk soup of ``c5_trees`` at its 15 positions (``trunks``, its
    ``InstancedTriArrays``): ``"axes near"``/``"axes far"``, rays of
    ``axis_rays`` from 0.5-3 m or 50-300 m with direction components exactly
    +-0 and the zero components of the origin on the planes of vertices;
    ``"zero normals"``, every trunk triangle moved into a plane of a
    coordinate (normal components exactly +-0) and rays at its edges;
    ``"far offsets"``, the trunk at three positions 2 km from the world
    origin and rays at its edges from within 10 m of it; ``"vertices"``, rays
    exactly at the trunks' vertices, half along an axis (a cap's apex joins
    twelve triangles, a side vertex six). In ``dtype``.
    Returns ``(tris, hierarchy, (p, d, t_cap))``."""
    import torch

    from eradiate_tpu_torch.kernels.tri_intersect import tri_instanced_bvh
    from eradiate_tpu_torch.ops.mesh import InstancedTriArrays, TriangleMeshArrays
    from eradiate_tpu_torch.test_tools import meshes

    rng = np.random.default_rng(seed)
    if kind == "ties":
        arrays, offsets, rays = meshes.instanced_tie_soup(rng, B, dtype=dtype)
    else:
        base = trunks.canonical
        arrays = tuple(x.cpu().numpy() for x in (base.v0, base.e1, base.e2))
        offsets = trunks.offsets.cpu().numpy()
        if kind == "zero normals":
            arrays = meshes.zero_normal_tris(rng, *arrays, share=1.0)
        soup = TriangleMeshArrays(*arrays)
        if kind == "far offsets":
            offsets = np.array([[2.0, 0, 0], [0, -2.0, 0], [1.4, 1.4, 0.3]])
            rays = meshes.edge_rays(rng, B, soup, offsets, origins=rng.uniform(-0.01, 0.01, (B, 3)),
                                    dtype=dtype)
        elif kind == "zero normals":
            rays = meshes.edge_rays(rng, B, soup, offsets, dtype=dtype)
        elif kind == "vertices":
            corners = np.concatenate([arrays[0], arrays[0] + arrays[1], arrays[0] + arrays[2]])
            rays = meshes.vertex_rays(rng, B, np.concatenate([corners + o for o in offsets]),
                                      dtype=dtype)
        else:
            rays = meshes.axis_rays(rng, B, soup, 1e-3 if kind.endswith("far") else 1e-5, offsets,
                                    dtype=dtype)
    to_dev = lambda a: torch.tensor(np.ascontiguousarray(a, dtype), device="cuda")  # noqa: E731
    tris = InstancedTriArrays(TriangleMeshArrays(*(to_dev(a) for a in arrays)), to_dev(offsets))
    c = tris.canonical
    return tris, tri_instanced_bvh(c.v0, c.e1, c.e2, tris.offsets), tuple(map(to_dev, rays))


def _sweep_calls(geometry, cull, rays):
    """{kernel: (wrapper, plain version, arguments)} for one leaf set or one
    triangle soup, flat or instanced; ``cull`` is the kernels' cull operand."""
    from eradiate_tpu_torch.kernels import leaf_intersect as li
    from eradiate_tpu_torch.kernels import tri_intersect as ti

    base = geometry.canonical if hasattr(geometry, "canonical") else geometry
    if hasattr(base, "centers"):
        mod, stem, table = li, "ray_leaves", (base.centers, base.normals, base.radii)
    else:
        mod, stem, table = ti, "ray_tris", (base.v0, base.e1, base.e2)
    args = (*rays, *table)
    suffix = ""
    if hasattr(geometry, "canonical"):
        args, suffix = (*args, geometry.offsets), "_instanced"
    return {
        n: ((lambda a, fn=getattr(mod, n): fn(*a, cull)), getattr(mod, n + "_plain"), args)
        for n in (f"{stem}_nearest{suffix}", f"{stem}_occluded{suffix}")
    }


def _sliced(plain, args, lanes):
    """Run a plain version over the lanes (the first three arguments: p, d,
    t_max) in slices that fit the card's memory: its [lanes, 512] float64
    temporaries would take about 8 GiB each at 2^21 lanes."""
    import torch

    B = args[0].shape[0]
    outs = []
    for start in range(0, B, lanes):
        sl = slice(start, start + lanes)
        out = plain(*[a[sl] for a in args[:3]], *args[3:])
        outs.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _item_pairs(geometry, rays, cap, occluded, subset, lanes=512):
    """The exact tests this data needs at item granularity, whatever cull
    implements the sweep: a (ray, item) pair counts where the ray's segment
    ``p + t d``, t in [0, cap], reaches both the item's own bounding sphere
    and its axis-aligned box (a triangle: the sphere about its box's centre
    through its farthest vertex; a disk: centre and radius), over all
    instances; an occluded shadow ray counts one test. Counted on the lanes
    ``subset`` (all where None) in slices of ``lanes``, and scaled to all of
    ``rays``. Splitting triangles into several references can go below
    it."""
    import torch

    base = geometry.canonical if hasattr(geometry, "canonical") else geometry
    offsets = geometry.offsets if hasattr(geometry, "canonical") else None
    if hasattr(base, "centers"):
        c, r = base.centers, base.radii
        half = r[:, None] * torch.sqrt(torch.clamp(1.0 - base.normals**2, min=0.0))
        lo, hi, r2 = c - half, c + half, r * r
    else:
        verts = torch.stack([base.v0, base.v0 + base.e1, base.v0 + base.e2], dim=1)
        lo, hi = verts.min(dim=1).values, verts.max(dim=1).values
        c = 0.5 * (lo + hi)
        r2 = ((verts - c[:, None]) ** 2).sum(-1).max(dim=1).values
    p, d = rays[0], rays[1]
    if subset is not None:
        p, d, cap = p[subset], d[subset], cap[subset]
        occluded = None if occluded is None else occluded[subset]
    if offsets is None:
        offsets = p.new_zeros((1, 3))
    inv = 1.0 / d
    total = 0
    for start in range(0, p.shape[0], lanes):
        sl = slice(start, start + lanes)
        dd, ii, cc = d[sl, None], inv[sl, None], cap[sl, None]
        neg = ii < 0
        count = torch.zeros(dd.shape[0], dtype=torch.int64, device=p.device)
        for off in offsets:
            q = (p[sl] - off)[:, None]
            v = c[None] - q
            tc = torch.minimum(torch.clamp((v * dd).sum(-1), min=0.0), cc)
            e = v - dd * tc[..., None]
            sphere = (e * e).sum(-1) <= r2[None]
            a, b = (lo[None] - q) * ii, (hi[None] - q) * ii
            near, far = torch.where(neg, b, a), torch.where(neg, a, b)
            t_near = torch.fmax(torch.fmax(torch.fmax(near[..., 0], near[..., 1]),
                                           near[..., 2]), torch.zeros_like(cc))
            t_far = torch.fmin(torch.fmin(torch.fmin(far[..., 0], far[..., 1]), far[..., 2]), cc)
            count += (sphere & (t_near <= t_far)).sum(-1)
        if occluded is not None:
            count = torch.where(occluded[sl], torch.clamp(count, max=1), count)
        total += int(count.sum())
    return total * rays[0].shape[0] / p.shape[0]


def _leaves_reached(bvh, rays, caps, subset, lanes=256):
    """Mean leaves of a hierarchy whose box the flat kernels' cull reaches,
    per ray of ``subset``, for each cap of ``caps``."""
    import torch

    from eradiate_tpu_torch.kernels import bvh as hierarchy

    p, d = rays[0][subset], rays[1][subset]
    lo, hi = (torch.from_numpy(x).to(p.device) for x in hierarchy.bvh_leaves(bvh)[2:])
    sums = [0] * len(caps)
    for start in range(0, p.shape[0], lanes):
        sl = slice(start, start + lanes)
        for k, cap in enumerate(caps):
            box = hierarchy.box_ray(p[sl], d[sl], cap[subset][sl])  # float64: as the kernels
            sums[k] += int(hierarchy._box_reach(*box, lo, hi).sum())
    return [n / p.shape[0] for n in sums]


def _instances_reached(ibvh, rays, caps, subset, lanes=256):
    """Per ray of ``subset`` and for each cap of ``caps``, the mean instance
    boxes whose top leaf the instanced kernels' world-ray cull reaches, and
    the mean canonical leaves that the translated ray reaches in those
    instances: ``[(instances, canonical leaves), ...]``."""
    import torch

    from eradiate_tpu_torch.kernels import bvh as hierarchy

    p, d = rays[0][subset], rays[1][subset]
    I = ibvh.instances.shape[0]
    inst_leaf = torch.from_numpy(hierarchy.leaf_of_row(ibvh.top, I)).to(p.device)
    top_lo, top_hi = (torch.from_numpy(x).to(p.device) for x in hierarchy.bvh_leaves(ibvh.top)[2:])
    lo, hi = (torch.from_numpy(x).to(p.device)
              for x in hierarchy.bvh_leaves(ibvh.canonical)[2:])
    sums = [[0, 0] for _ in caps]
    for start in range(0, p.shape[0], lanes):
        sl = slice(start, start + lanes)
        for k, cap in enumerate(caps):
            c = cap[subset][sl]
            on = hierarchy._box_reach(*hierarchy.box_ray(p[sl], d[sl], c), top_lo,
                                      top_hi)[:, inst_leaf]  # [L, I]
            sums[k][0] += int(on.sum())
            for j in range(I):
                leaves = hierarchy._box_reach(
                    *hierarchy.box_ray(p[sl] - ibvh.instances[j, :3], d[sl], c), lo, hi)
                sums[k][1] += int((leaves & on[:, j : j + 1]).sum())
    return [(a / p.shape[0], b / p.shape[0]) for a, b in sums]


def _stats_lanes(B, subset, device, seed):
    """The lanes (a tensor of indices) on which a timed sweep check counts
    its bound's exact tests and the hierarchy a ray reaches: the plain
    version's lanes, or a seeded sample of :data:`STATS_LANES` of them where
    there are more."""
    import torch

    lanes = subset if subset is not None else torch.arange(B, device=device)
    if lanes.shape[0] <= STATS_LANES:
        return lanes
    keep = np.sort(np.random.default_rng(seed + 1).choice(lanes.shape[0], STATS_LANES,
                                                          replace=False))
    return lanes[torch.tensor(keep, device=device)]


def check_sweep_kernels(name, geometry, cull, rays, seed, timed=False,
                        plain_lanes=PLAIN_LANES):
    """The two sweep kernels (nearest and any hit) of one leaf set or one
    triangle soup, flat or instanced, against their plain versions on the
    card: every output equal bit pattern for bit pattern (floats compared
    as int32, float64 as int64, so a -0.0 is not taken for a +0.0). Float64
    operands run the float64 builds, whose results are keyed by the
    kernel's name with ``_f64`` and bounded over the float64 rate. The
    kernels run on all of ``rays``; the plain versions on a
    seeded subset of ``plain_lanes`` of them where there are more (in slices
    that fit the card's memory). Returns ({kernel: max abs error}, {kernel:
    {"ms", "device_ms", "device_by", "plain_ms", "lanes", "plain_lanes"}},
    {kernel: (bound ms, bound by)}, {kernel: what a ray reaches of the
    hierarchy with the cap at its nearest hit}), the last three filled where
    ``timed``.

    The bound: rays read once (28 bytes a lane), the table read once, the
    outputs written once (17 bytes a lane for nearest, 1 for any hit); the
    exact tests the data needs at item granularity (:func:`_item_pairs` on
    :func:`_stats_lanes`, scaled to all lanes), ~30 float32 operations
    a disk test and ~45 a Moller-Trumbore test. For the flat kernels, the
    leaves of their hierarchy that a ray reaches are printed too, and for
    the instanced kernels the instance boxes and canonical leaves, with the
    cap at the nearest hit and at ``t_max``."""
    import torch

    from eradiate_tpu_torch.kernels import bvh as hierarchy
    from eradiate_tpu_torch.kernels import leaf_intersect as li
    from eradiate_tpu_torch.kernels import tri_intersect as ti

    base = geometry.canonical if hasattr(geometry, "canonical") else geometry
    offsets = geometry.offsets if hasattr(geometry, "canonical") else None
    is_leaves = hasattr(base, "centers")
    item_ops = 30.0 if is_leaves else 45.0
    f64 = rays[0].dtype == torch.float64
    suffix, peak = ("_f64", PEAK_F64_FLOPS) if f64 else ("", PEAK_F32_FLOPS)
    n_items = (base.centers if is_leaves else base.v0).shape[0]
    slice_lanes = 2**17 if is_leaves else 2**15  # [lanes, 512(, 3)] float64 temporaries
    B = rays[0].shape[0]
    subset = None
    if B > plain_lanes:
        # a seeded sample, and always the last lanes (a ragged lane
        # count's partial block)
        tail = min(SAMPLE_TAIL, plain_lanes)
        chosen = np.concatenate([
            np.random.default_rng(seed).choice(B - tail, plain_lanes - tail, replace=False),
            np.arange(B - tail, B)])
        chosen = np.sort(chosen)
        subset = torch.tensor(chosen, device=rays[0].device)
    n_plain = B if subset is None else plain_lanes
    table = (base.centers, base.normals, base.radii) if is_leaves else (base.v0, base.e1, base.e2)
    errs, times, bounds, reach, notes = {}, {}, {}, {}, []
    for kernel, (fn, plain, args) in _sweep_calls(geometry, cull, rays).items():
        kernel += suffix
        got = fn(args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        held, plain_args = got, args
        if subset is not None:
            held = tuple(g[subset] for g in got)
            plain_args = (*[a[subset].contiguous() for a in args[:3]], *args[3:])
        # the plain version runs once: the run that is compared is the run
        # that is timed
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = _sliced(plain, plain_args, slice_lanes)
        end.record()
        end.synchronize()
        labels = ("t", "normal", "hit") if len(got) == 3 else ("occluded",)
        err = 0.0
        for label, g, w in zip(labels, held, want):
            if g.dtype != w.dtype:
                raise AssertionError(f"{name}: {kernel} {label} is {g.dtype}, the plain "
                                     f"version's {w.dtype}")
            bits = torch.int64 if g.dtype == torch.float64 else torch.int32
            gb, wb = (x.view(bits) if x.is_floating_point() else x for x in (g, w))
            differ = int((gb != wb).reshape(n_plain, -1).any(dim=1).sum())
            if differ:
                detail = f"{differ} of {n_plain} lanes"
                if g.dtype == torch.float32:
                    ulps = _ulps(g.cpu().numpy().ravel(), w.cpu().numpy().ravel())
                    detail += f", max {int(ulps.max())} ulp"
                raise AssertionError(
                    f"{name}: {kernel} {label} differs from the plain version: {detail}"
                )
            err = max(err, float((g.double() - w.double()).abs().max()))
        errs[kernel] = err
        share = float(got[-1].float().mean())
        notes.append(f"{kernel} {'hit' if len(got) == 3 else 'occluded'} share {share:.3f}")
        if timed:
            device, by = _device_ms(lambda: fn(args), KERNELS[kernel])
            times[kernel] = {"ms": _time_ms(lambda: fn(args)), "device_ms": device,
                             "device_by": by, "plain_ms": start.elapsed_time(end), "lanes": B,
                             "plain_lanes": n_plain}
            tensors = tuple(rays) + table + (() if offsets is None else (offsets,)) + got
            n_bytes = sum(t.numel() * t.element_size() for t in tensors)
            cap, occ = (got[0], None) if len(got) == 3 else (rays[2], got[0])
            # the bound's and the reach's counts are estimates scaled to
            # every lane: a seeded sample of STATS_LANES lanes
            stats = _stats_lanes(B, subset, rays[0].device, seed)
            pairs = _item_pairs(geometry, rays, cap, occ, stats)
            bounds[kernel] = bound_ms(n_bytes, item_ops * pairs, peak)
            notes[-1] += (f", kernel {times[kernel]['ms']:.4f} ms (device "
                          f"{device:.4f} by the {by}), plain "
                          f"{times[kernel]['plain_ms']:.1f} ms at {n_plain} lanes, {pairs / B:.2f} "
                          f"exact tests a ray at item granularity, bound "
                          f"{bounds[kernel][0]:.4f} ms by {bounds[kernel][1]}")
            lanes = stats
            items = "disks" if is_leaves else "triangles"
            if isinstance(cull, (ti.TriBVH, li.LeafBVH)) and len(got) == 3:
                at_hit, at_max = _leaves_reached(cull, rays, (got[0], rays[2]), lanes)
                reach[kernel] = {"leaves": at_hit}
                notes[-1] += (f"; the hierarchy's leaves a ray reaches: {at_hit:.2f} with the "
                              f"cap at the nearest hit, {at_max:.2f} with t_max ("
                              f"{n_items / hierarchy.bvh_leaves(cull)[0].size:.2f} "
                              f"{items} a leaf)")
            if isinstance(cull, (ti.InstancedTriBVH, li.InstancedLeafBVH)) and len(got) == 3:
                (ih, lh), (im, lm) = _instances_reached(cull, rays, (got[0], rays[2]), lanes)
                reach[kernel] = {"instance_boxes": ih, "canonical_leaves": lh}
                notes[-1] += (f"; a ray reaches {ih:.2f} instance boxes and {lh:.2f} canonical "
                              f"leaves in them with the cap at the nearest hit, {im:.2f} and "
                              f"{lm:.2f} with t_max ("
                              f"{n_items / hierarchy.bvh_leaves(cull.canonical)[0].size:.2f} "
                              f"{items} a leaf)")
    held_on = "every lane" if subset is None else f"{n_plain} seeded lanes"
    print(f"  {name}: B={B} N={n_items}"
          + (f" I={offsets.shape[0]}" if offsets is not None else "")
          + f" every output's bit pattern equal on {held_on}, 0 lanes differ; "
          + "; ".join(notes),
          flush=True)
    return errs, times, bounds, reach


def _fields(obj, prefix=""):
    """{name: value} of a hierarchy's fields, nested hierarchies flattened
    (``canonical.nodes``)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


def check_rebuild(label, cull, build):
    """Build a table's or soup's hierarchy once more on the host
    (``build``), timed, print its depths and size, and hold it bit for bit
    against ``cull``, the build of the same inputs, every field and every
    nested hierarchy's field; returns the seconds."""
    import torch

    from eradiate_tpu_torch.kernels import bvh as hierarchy

    t0 = time.perf_counter()
    again = build()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want, got = _fields(cull), _fields(again)
    arrays = {k: v for k, v in want.items() if isinstance(v, torch.Tensor)}
    same = want.keys() == got.keys() and all(
        torch.equal(got[k].view(torch.int32), v.view(torch.int32)) if k in arrays
        else got[k] == v
        for k, v in want.items()
    )
    depths = ", ".join(f"{k} {v}" for k, v in want.items() if k not in arrays)
    items = next(v for k, v in arrays.items() if k.endswith(("disks", "tris")))
    nodes = next(v for k, v in arrays.items() if k.endswith("nodes"))
    print(f"  {label} hierarchy: N={items.shape[0]}"
          + (f" I={want['instances'].shape[0]} ({want['top'].shape[0]} top nodes)"
             if "instances" in want else "")
          + f" built on the host in {seconds:.3f} s, {depths}, {nodes.shape[0]} inner "
          f"nodes, {hierarchy.bvh_leaves(nodes)[0].size} leaves, "
          f"{sum(v.numel() for v in arrays.values()) * 4 / 2**20:.2f} MiB; rebuilt "
          f"bitwise equal: {same}", flush=True)
    if not same:
        raise AssertionError(f"two builds of the {label} hierarchy differ")
    return seconds


def instanced_against_flat(exp, B, seed, mesh_dir, plain_lanes=2**16, dtype=np.float32):
    """The instanced triangle kernels on the wood skeleton as canonical soup
    (N = 6180, I = 15; its two-level hierarchy built and timed here) against
    the flat kernels on the flattened soup of ``exp`` (the same 92700
    triangles), on the same rays, both timed. Translating the ray
    (instanced) and translating the vertices (flat) round differently, so a
    ray through a shared edge may hit a triangle in one form and slip past it
    in the other, to a miss or to the triangle behind: the lanes whose
    ``hit``/``occluded`` flag differs or whose ``t`` differs by more than
    1e-6 km are counted, printed, and held under 1e-3 of the lanes. The
    instanced kernels' bound counts the exact tests at item granularity
    (:func:`_item_pairs` on ``plain_lanes`` seeded lanes, scaled), as
    :func:`check_sweep_kernels` does. In ``dtype``: float64 runs the float64
    builds (the flat soup compiled in the double mode that is set), keyed
    ``_f64`` and bounded over the float64 rate. Returns the instanced
    kernels' {kernel: {"ms", "device_ms", "device_by", "bound_ms",
    "bound_by"}}."""
    import torch

    from eradiate_tpu_torch.kernels.tri_intersect import tri_instanced_bvh
    from eradiate_tpu_torch.ops.mesh import (
        InstancedTriArrays,
        TriangleMeshArrays,
        mesh_from_vertices,
    )
    from eradiate_tpu_torch.scenes.shapes import FileMeshShape

    *_, flat, flat_bvh, rays = _canopy_inputs(exp, B, seed)
    if rays[0].dtype != (torch.float64 if dtype == np.float64 else torch.float32):
        raise AssertionError(f"the c5_wood soup did not compile in {np.dtype(dtype)}")
    suffix, peak = ("_f64", PEAK_F64_FLOPS) if dtype == np.float64 else ("", PEAK_F32_FLOPS)
    v, f = FileMeshShape(filename=_wood_obj(mesh_dir), mesh_units="m").triangles()
    soup = mesh_from_vertices(v.astype(dtype), f)
    to_dev = lambda a: torch.tensor(np.asarray(a, dtype), device="cuda")  # noqa: E731
    canonical = TriangleMeshArrays(to_dev(soup.v0), to_dev(soup.e1), to_dev(soup.e2))
    offsets = to_dev(np.atleast_2d(exp.canopy.instanced_canopy_elements[1].instance_positions))
    inst = InstancedTriArrays(canonical, offsets)
    ibvh = tri_instanced_bvh(canonical.v0, canonical.e1, canonical.e2, offsets)
    check_rebuild("wood skeleton instanced", ibvh, lambda: tri_instanced_bvh(
        canonical.v0, canonical.e1, canonical.e2, offsets))
    flat_calls = _sweep_calls(flat, flat_bvh, rays)
    inst_calls = _sweep_calls(inst, ibvh, rays)
    subset = torch.tensor(np.sort(np.random.default_rng(seed).choice(B, plain_lanes, replace=False)),
                          device="cuda")
    out, notes = {}, []
    for (k_flat, (fn_f, _, a_f)), (k_inst, (fn_i, _, a_i)) in zip(
        flat_calls.items(), inst_calls.items()
    ):
        k_flat, k_inst = k_flat + suffix, k_inst + suffix
        got_f, got_i = fn_f(a_f), fn_i(a_i)
        got_f, got_i = (g if isinstance(g, tuple) else (g,) for g in (got_f, got_i))
        differ = got_f[-1] != got_i[-1]
        note = f"{k_inst}: {int(differ.sum())} of {B} lanes flip against {k_flat}"
        if len(got_f) == 3:
            dt = (got_f[0] - got_i[0]).abs()
            moved = got_f[2] & got_i[2] & (dt > 1e-6)
            same = got_f[2] & got_i[2] & ~moved
            note += (f", {int(moved.sum())} hit another triangle, max |dt| "
                     f"{float(dt[same].max()):.3e} km on the others")
            differ = differ | moved
        if int(differ.sum()) > 1e-3 * B:
            raise AssertionError(f"{k_inst} and {k_flat} disagree on {int(differ.sum())} of "
                                 f"{B} lanes")
        ms_i, ms_f = _time_ms(lambda: fn_i(a_i)), _time_ms(lambda: fn_f(a_f))
        dev_i, by_i = _device_ms(lambda: fn_i(a_i), KERNELS[k_inst])
        tensors = (*rays, canonical.v0, canonical.e1, canonical.e2, offsets, *got_i)
        cap, occ = (got_i[0], None) if len(got_i) == 3 else (rays[2], got_i[0])
        pairs = _item_pairs(inst, rays, cap, occ, subset)
        bound = bound_ms(sum(t.numel() * t.element_size() for t in tensors), 45.0 * pairs, peak)
        out[k_inst] = {"ms": ms_i, "device_ms": dev_i, "device_by": by_i, "bound_ms": bound[0],
                       "bound_by": bound[1]}
        note += (f"; {ms_i:.4f} ms (device {dev_i:.4f} by the {by_i}) against {ms_f:.4f} ms; "
                 f"{pairs / B:.2f} "
                 f"exact tests a ray at item granularity, bound {bound[0]:.4f} ms by {bound[1]}")
        if len(got_i) == 3:
            (ih, lh), (im, lm) = _instances_reached(ibvh, rays, (got_i[0], rays[2]), subset)
            note += (f"; a ray reaches {ih:.2f} instance boxes and {lh:.2f} canonical leaves "
                     f"in them with the cap at the nearest hit, {im:.2f} and {lm:.2f} with "
                     f"t_max")
        notes.append(note)
    print(f"  wood skeleton instanced (N={canonical.v0.shape[0]} I={offsets.shape[0]}) against "
          f"flat (N={flat.v0.shape[0]}), B={B}: " + "; ".join(notes), flush=True)
    return out


#: The mode of the polarized phases (``bench.py`` names ``mono_polarized``,
#: the double-precision mode, whose path state the JAX package keeps in
#: float32 without x64; the port's double modes are not ported).
POLARIZED_MODE = "mono_polarized_single"


def stokes_gate(gpu, cpu):
    """(max relative I difference, max |z| of the Stokes components): each
    component's difference over the standard deviation of the two runs' I
    estimates (the only variances the runs keep)."""
    rel = np.abs(gpu["I"] - cpu["I"]) / np.abs(cpu["I"])
    sd = np.sqrt(gpu["var"] + cpu["var"])
    z = 0.0
    for c in "IQUV":
        diff = np.abs(gpu[c] - cpu[c])
        z = max(z, float(np.max(np.where(diff > 0, diff, 0.0) / np.where(diff > 0, sd, 1.0))))
    return float(rel.max()), z


def _nadir(ds):
    """I, Q/I and DoLP at the view nearest nadir, and that view's zenith."""
    i = int(np.argmin(np.abs(np.asarray(ds["vza"]))))
    I, Q, dolp = (float(np.asarray(ds[k])[0, i]) for k in ("I", "Q", "dolp"))
    return I, Q / I, dolp, float(np.asarray(ds["vza"])[i])


def _cpu_worker_init():
    """Set-up of :class:`CpuRenders`' process: it sees no card and runs one
    thread."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(1)


def _gate_spp(variant):
    """Samples a pixel of a canopy gate: 64, phase D's :data:`SPP_D`."""
    return SPP_D if variant in C5_GROUNDS or variant == "aerosol" else GATE_SPP


def _cpu_c5_render(mode, form, branches, stokes, variant=None):
    """One 64-spp render of a form of the c5 scene (``variant``, phase D's:
    :data:`SPP_D`; see :func:`_c5`) on the CPU in ``mode``, at the seed of
    the CUDA runs (:class:`CpuRenders`' job): its data variables as numpy
    arrays, and the seconds it took."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as mesh_dir:
        ds = etp.run(_c5(form, mesh_dir, branches, stokes, variant), spp=_gate_spp(variant),
                     seed_state=etp.SeedState(SEED), device="cpu")
        out = {k: np.asarray(ds[k]) for k in ds.data_vars}
    return out, time.perf_counter() - t0


def _cpu_case_render(mode, case, size):
    """One render of a scene of phases E-G (:func:`_sensor_case`) on the CPU
    in ``mode`` at :data:`GATE_SPP` and the seed of the CUDA runs: its data
    variables as numpy arrays, and the seconds it took."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    t0 = time.perf_counter()
    ds = etp.run(_sensor_case(case, size), spp=GATE_SPP, seed_state=etp.SeedState(SEED),
                 device="cpu")
    return {k: np.asarray(ds[k]) for k in ds.data_vars}, time.perf_counter() - t0


class CpuRenders:
    """The CPU sides of the CUDA-against-CPU gates of the canopy phases (12,
    17, 22, 40, 43, D, H), of c3's (25, 31) and of phases E-G, rendered in
    ``workers`` background processes, one thread each, that see no card:
    submitted at the start and collected where a phase compares them with
    its CUDA run, so that their minutes overlap the card's work. The
    processes end in :meth:`close` (registered at exit)."""

    def __init__(self, workers=1):
        import atexit
        import multiprocessing

        self._pool = multiprocessing.get_context("spawn").Pool(workers,
                                                               initializer=_cpu_worker_init)
        self._jobs = {}
        atexit.register(self.close)

    def submit(self, fn, *args):
        """Queue ``fn(*args)`` (:func:`_cpu_c5_render` or
        :func:`_cpu_case_render`), once for each ``fn`` and ``args``."""
        key = (fn.__name__, args)
        if key not in self._jobs:
            self._jobs[key] = self._pool.apply_async(fn, args)

    def get(self, fn, *args):
        """The render's (data variables, seconds), waiting for it."""
        self.submit(fn, *args)
        return self._jobs[fn.__name__, args].get()

    def close(self):
        self._pool.terminate()
        self._pool.join()


def c5_cuda_vs_cpu(form, phase, cpu, mesh_dir=None, branches=WOOD_BRANCHES, stokes=False,
                   variant=None):
    """The port on CUDA against the port on the CPU for one form of the
    canopy, 64 spp at one seed. Scalar: every pixel within |z| <= 5, the
    median pixel within 1e-4 relative. With ``stokes`` (in
    ``mono_polarized_single``), the gate of phase 20: I within 1e-4 relative
    on every pixel and each Stokes component within |z| <= 5. The CPU run
    comes from ``cpu`` (:class:`CpuRenders`); ``variant`` as :func:`_c5`, at
    :data:`SPP_D`. A camera (``variant`` ``spot_gate``, phase H) takes the
    canopy gate over the pixels the CPU run lit (:func:`_lit_gate`): max
    relative 2e-3, median 1e-4, |z| <= 5, Q, U and V in the |z| with Stokes
    output. Returns the CUDA run's launches."""
    import eradiate_tpu_torch as etp

    mode = etp.mode()
    reset_launches()
    spp = _gate_spp(variant)
    ds = etp.run(_c5(form, mesh_dir, branches, stokes, variant), spp=spp,
                 seed_state=etp.SeedState(SEED), device="cuda")
    gpu = {k: np.asarray(ds[k]) for k in ds.data_vars}
    launches = read_launches()
    cpu, seconds = cpu.get(_cpu_c5_render, mode.id, form, branches, stokes, variant)
    if "brf" not in cpu:
        got = _lit_gate(gpu, cpu)
        label = (f"[{phase}] {'polarized ' if stokes else ''}c5 scene ({form}, {mode.id}, "
                 f"{variant}), 8 x 8 camera, {spp} spp")
        print(f"{label}, CUDA vs CPU: "
              + (f"max rel {got[0]:.3e} (bound 2e-3), median {got[1]:.3e} (bound 1e-4), max "
                 f"|z| {got[2]:.3e} (bound 5)" if got else "a pixel dark in one run only")
              + f"; the CPU run took {seconds:.1f} s", flush=True)
        if got is None or got[0] > 2e-3 or got[1] > 1e-4 or got[2] > 5.0:
            raise AssertionError(f"CUDA and CPU runs of the port disagree on the c5 scene "
                                 f"({form}, {variant})")
        return launches
    if mode.is_double_precision and not gpu["brf"].dtype == cpu["brf"].dtype == np.float64:
        raise AssertionError(f"the c5 scene ({form}) in {mode.id} did not render in float64")
    brf_g, brf_c = gpu["brf"], cpu["brf"]
    rel = np.abs(brf_g - brf_c) / np.abs(brf_c)
    zmax = float(np.max(np.abs(gpu["radiance"] - cpu["radiance"])
                        / np.sqrt(gpu["var"] + cpu["var"])))
    label = (f"[{phase}] {'polarized ' if stokes else ''}c5 scene ({form}, {mode.id}, "
             f"{gpu['brf'].dtype}{', ' + variant if variant else ''}), {N_VZA_C5} VZA {spp} spp")
    if stokes:
        rel_I, z = stokes_gate(gpu, cpu)
        print(f"{label}, CUDA vs CPU: max rel I diff {rel_I:.3e} (bound 1e-4), max |z| of I, Q, "
              f"U, V {z:.3e} (bound 5); the CPU run took {seconds:.1f} s; "
              f"launches {', '.join(f'{k} {n}' for k, n in launches.items() if n)}",
              flush=True)
        if not (np.isfinite(gpu["I"]).all() and rel_I <= 1e-4 and z <= 5.0):
            raise AssertionError(f"CUDA and CPU runs of the port disagree on the polarized c5 "
                                 f"scene ({form})")
        return launches
    print(f"{label}, CUDA vs CPU: max rel BRF diff {rel.max():.3e}, median "
          f"{np.median(rel):.3e} (bound 1e-4), max |z| {zmax:.3e} (bound 5); the CPU run took "
          f"{seconds:.1f} s", flush=True)
    if not (np.isfinite(brf_g).all() and np.median(rel) <= 1e-4 and zmax <= 5.0):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on the c5 scene ({form})")
    return launches


def polarized_c1_cuda_vs_cpu(phase, label="polarized c1", make=None):
    """c1 (or ``make(11)``, c2) with Stokes output at 11 view zeniths and
    256 spp, one seed, on CUDA and on the CPU: I within 1e-4 relative, each
    Stokes component of each pixel within |z| <= 5. Returns the CUDA run's
    launches."""
    import eradiate_tpu_torch as etp

    out = {}
    for dev in ("cuda", "cpu"):
        exp = _c1(11, stokes=True) if make is None else make(11)
        reset_launches()
        ds = etp.run(exp, spp=256, seed_state=etp.SeedState(SEED), device=dev)
        if dev == "cuda":
            launches = read_launches()
        out[dev] = {k: np.asarray(ds[k]) for k in ds.data_vars}
    rel, z = stokes_gate(out["cuda"], out["cpu"])
    print(f"[{phase}] {label} 11 VZA 256 spp, CUDA vs CPU: max rel I diff {rel:.3e} "
          f"(bound 1e-4), max |z| of I, Q, U, V {z:.3e} (bound 5)", flush=True)
    if not (np.isfinite(out["cuda"]["I"]).all() and rel <= 1e-4 and z <= 5.0):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on {label}")
    return launches


def _polarized_full_width(exp, spp, n_vza, module, attr, skip, window, label):
    """One full-width run with the profiler on for a window of ``window``
    bounce iterations after ``skip`` (it warms the card and the allocator),
    then a timed run; returns (dataset, launches, iterations, wall s, peak
    GiB, profiler, kernels an iteration, device ms an iteration)."""
    import torch

    import eradiate_tpu_torch as etp

    def run():
        return etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")

    prof = profile_window(run, module, attr, skip, window)
    per_it, dev_ms, shares = window_device(prof, window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    samples = n_vza * spp
    I, q, dolp, vza = _nadir(ds)
    print(f"{label}: {n_vza} VZA x {spp} spp = {samples} samples, wall {wall:.3f} s, "
          f"{samples / wall:.4e} samples/s, {iterations} bounce iterations "
          f"({1e3 * wall / iterations:.3f} ms each), peak device memory {peak:.2f} GiB",
          flush=True)
    print(f"    launches {launches}; at VZA {vza:.2f}: I {I:.6e}, Q/I {q:.6f}, DoLP {dolp:.6f}; "
          f"profiler window of {window} iterations (warm-up run): {per_it:.1f} CUDA kernels and "
          f"{dev_ms:.3f} ms of device time an iteration, busy share "
          f"{dev_ms * iterations / (1e3 * wall):.3f} of the timed run's wall; device time by "
          f"kernel family: {', '.join(f'{f} {x:.3f}' for f, x in shares.items())}", flush=True)
    stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
    dolp_all = np.asarray(ds["dolp"])
    if stokes.shape != (1, n_vza, 4) or not np.isfinite(stokes).all():
        raise AssertionError(f"{label}: Stokes vectors not finite or of the wrong shape")
    if not ((stokes[..., 0] > 0).all() and (dolp_all >= 0).all() and (dolp_all <= 1).all()):
        raise AssertionError(f"{label}: I not positive or DoLP outside [0, 1]")
    return ds, launches, iterations, wall, peak, prof, per_it, dev_ms


def polarized_c1_full_width(phase, label="polarized c1", exp=None, spp=SPP_C1, skip=100):
    """Polarized c1 (or ``exp`` at ``spp``, c2) at full width: K1's launches
    must equal the bounce iterations, and it alone launches; its device time
    a launch inside the run from the profiler's window of 48 iterations
    after ``skip``. Returns (launches, run device ms of K1)."""
    from eradiate_tpu_torch.ops import tracer_polarized

    ds, launches, iterations, wall, peak, prof, per_it, dev_ms = _polarized_full_width(
        _c1(N_VZA, stokes=True) if exp is None else exp, spp, N_VZA, tracer_polarized,
        "collision_fetch", skip, 48, f"[{phase}] {label} full width")
    n, ms = kernel_ms_in_window(prof, KERNELS["collision_fetch"], RUN_WINDOW_MIN)
    print(f"    collision_fetch launches {launches['collision_fetch']}, bounce iterations "
          f"{iterations}; device time a launch inside the run {ms:.4f} ms ({n} profiler "
          "records)", flush=True)
    if not (launches["collision_fetch"] > 0 and launches["collision_fetch"] == iterations):
        raise AssertionError(f"{label} did not run through K1 once per bounce")
    if any(k for k, v in launches.items() if v and k != "collision_fetch"):
        raise AssertionError(f"{label} launched a kernel of another path")
    return launches, ms


def polarized_c5_full_width(phase, scalar_ds, suffix="", against="the scalar run's, phase 13"):
    """Polarized c5 (instanced) at full width in the mode that is set: K7
    nearest and any-hit launches (their float64 builds', with ``suffix``
    ``"_f64"``) must each equal the bounce iterations, and they alone
    launch; each one's device time a launch inside the run from the
    profiler's window. Returns (launches, {kernel: run device ms}, the
    run's numbers: wall, samples/s, iterations, kernels and device ms an
    iteration, busy share, peak GiB, BRF at nadir)."""
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer_canopy_polarized

    mode = etp.mode().id
    ds, launches, iterations, wall, peak, prof, per_it, dev_ms = _polarized_full_width(
        _c5("instanced", stokes=True), SPP_C5, N_VZA_C5, tracer_canopy_polarized,
        "leaf_nearest", 20, 40, f"[{phase}] polarized c5 scene (instanced, {mode}) full width")
    mine = tuple(k + suffix for k in C5_KERNELS["instanced"])
    in_run = {k: kernel_ms_in_window(prof, KERNELS[k], 20)[1] for k in mine}
    nadir = N_VZA_C5 // 2
    brf = np.asarray(ds["brf"])
    print(f"    {', '.join(f'{k} {ms:.4f} ms' for k, ms in in_run.items())} of device time a "
          f"launch inside the run; BRF at nadir {brf[0, nadir]:.6f} ({against}: "
          f"{np.asarray(scalar_ds['brf'])[0, nadir]:.6f}); BRF dtype {brf.dtype}", flush=True)
    if not all(launches[k] > 0 and launches[k] == iterations for k in mine):
        raise AssertionError(f"polarized c5 did not launch {mine} once per bounce")
    if any(n for k, n in launches.items() if k not in mine):
        raise AssertionError("polarized c5 launched a kernel of another path")
    stats = {"wall_s": wall, "samples_per_s": N_VZA_C5 * SPP_C5 / wall,
             "iterations": iterations, "kernels_an_iteration": per_it,
             "device_ms_an_iteration": dev_ms, "busy": dev_ms * iterations / (1e3 * wall),
             "peak_gib": peak, "brf_nadir": float(brf[0, nadir]), "ds": ds}
    return launches, in_run, stats


#: The kernels each form of the c5 scene launches once per bounce iteration.
C5_KERNELS = {
    "instanced": ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced"),
    "flat": ("ray_leaves_nearest", "ray_leaves_occluded"),
    "trees": ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced",
              "ray_tris_nearest_instanced", "ray_tris_occluded_instanced"),
    "wood": ("ray_leaves_nearest", "ray_leaves_occluded", "ray_tris_nearest",
             "ray_tris_occluded"),
}


def c5_full_width(form, spp, phase, mesh_dir=None):
    """A warm-up, then one timed run of one form of the c5 scene at ``spp``;
    returns (launch counts of the run by kernel, the dataset, the wall s)."""
    import torch

    import eradiate_tpu_torch as etp

    exp = _c5(form, mesh_dir)
    etp.run(exp, spp=4096, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    brf = np.asarray(ds["brf"])
    samples = N_VZA_C5 * spp
    print(f"[{phase}] c5 scene ({form}) full width: {N_VZA_C5} VZA x {spp} spp = {samples} "
          f"samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, {iterations} bounce "
          f"iterations ({1e3 * wall / iterations:.3f} ms each), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    launches {launches}; BRF finite {bool(np.isfinite(brf).all())}, shape "
          f"{brf.shape}, BRF at nadir: {brf[0, N_VZA_C5 // 2]:.6f}", flush=True)
    mine = C5_KERNELS[form]
    if not all(launches[k] > 0 and launches[k] == iterations for k in mine):
        raise AssertionError(f"the c5 scene ({form}) did not launch {mine} once per bounce")
    if any(n for k, n in launches.items() if k not in mine):
        raise AssertionError(f"the c5 scene ({form}) launched a kernel of another path")
    if brf.shape != (1, N_VZA_C5) or not np.isfinite(brf).all():
        raise AssertionError("c5 BRF is not finite or has the wrong shape")
    return launches, ds, wall


def c4_lr_flight_full_width(spp, phase):
    """Path B: c4 at SZA 75 through ``render_spherical`` with
    ``config.lr_flight`` at ``spp`` (a warm-up, then a timed run), held
    against the exact-NEE render (sun-tau table off, shell-event kernel) of
    the same scene and seed; returns the launch counts of the timed run and
    the kernels' device time a launch in one more run."""
    import dataclasses

    import torch

    from eradiate_tpu_torch.ops.tracer_spherical import render_spherical

    def compiled(exp):
        m = exp.measures[0]
        return exp.compile_scene(m, exp.spectral_context(m))

    scene, sensor, config = compiled(_c4(75.0))
    config_lr = dataclasses.replace(config, lr_flight=True)
    render_spherical(scene, sensor, config_lr, spp=4096, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = render_spherical(scene, sensor, config_lr, spp=spp, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = out["iterations"]
    rad = out["radiance"].cpu().numpy()
    samples = N_VZA_C4 * spp
    print(f"[{phase}] c4 SZA 75 with lr_flight, full width: {N_VZA_C4} VZA x {spp} spp = "
          f"{samples} samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, "
          f"{iterations} event iterations ({1e3 * wall / iterations:.3f} ms each), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    launches {launches}; radiance finite {bool(np.isfinite(rad).all())}, shape "
          f"{rad.shape}", flush=True)
    mine = ("shell_flight", "slant_tau")
    if not all(launches[k] > 0 and launches[k] == iterations for k in mine):
        raise AssertionError(f"c4 with lr_flight did not launch {mine} once per event")
    if any(n for k, n in launches.items() if k not in mine):
        raise AssertionError("c4 with lr_flight launched a kernel of another path")
    if rad.shape != (1, N_VZA_C4) or not (np.isfinite(rad).all() and (rad > 0).all()):
        raise AssertionError("c4 radiance with lr_flight is not finite and positive")
    in_run, sums, lanes = launch_ms_in_run(
        lambda: render_spherical(scene, sensor, config_lr, spp=spp, seed=SEED, device="cuda"),
        mine)
    _print_in_run(in_run, sums, lanes)

    scene_x, sensor_x, config_x = compiled(_c4(75.0, sun_tau_table=False))
    if scene_x.medium.sun_tau is not None:
        raise AssertionError("the sun-tau table is still on")
    exact = render_spherical(scene_x, sensor_x, config_x, spp=spp, seed=SEED, device="cuda")
    rad_x = exact["radiance"].cpu().numpy()
    differ = int((rad != rad_x).sum())
    rel = np.abs(rad - rad_x) / np.abs(rad_x)
    print(f"    against the exact-NEE render (shell_event): {differ} of {rad.size} pixels "
          f"differ, max rel {rel.max():.3e}, iterations {exact['iterations']}", flush=True)
    if differ:
        var = (out["m2"].cpu().numpy() - rad**2 + exact["m2"].cpu().numpy() - rad_x**2) / spp
        z = np.abs(rad - rad_x) / np.sqrt(np.maximum(var, 1e-30))
        print(f"    max |z| {z.max():.3e} (bound 5), median rel {np.median(rel):.3e} "
              f"(bound 1e-5)", flush=True)
        if not (z.max() <= 5.0 and np.median(rel) <= 1e-5):
            raise AssertionError("lr_flight and the exact-NEE render disagree")
    return launches, in_run


def _max_z(a, b, var):
    """The largest |a - b| over the standard deviation sqrt(var) (pixels
    that agree exactly count 0)."""
    diff = np.abs(a - b)
    return float(np.max(np.where(diff > 0, diff, 0.0) / np.where(diff > 0, np.sqrt(var), 1.0)))


def _rows_render(make, stokes, device, spp=256):
    """``make(11)`` at ``spp`` and the seed of the gates on ``device``: the
    variables :func:`rows_cuda_vs_cpu` (``stokes``:
    :func:`polarized_rows_cuda_vs_cpu`) compares, as numpy arrays, and the
    seconds the run took."""
    import eradiate_tpu_torch as etp

    exp = make(11)
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device=device)
    seconds = time.perf_counter() - t0
    raw = exp.measures[0].results["raw"]
    if stokes:
        st = np.asarray(raw["stokes"], np.float64)
        return {"I": np.asarray(ds["I"]), "rows": st, "iterations": raw["iterations"],
                "var": np.maximum(np.asarray(raw["m2"]) - st[..., 0] ** 2, 0.0)
                / raw["spp"]}, seconds
    rad, m2 = (np.asarray(raw[k], np.float64) for k in ("radiance", "m2"))
    return {"brf": np.asarray(ds["brf"]), "radiance": np.asarray(ds["radiance"]),
            "var": np.asarray(ds["var"]), "rows": rad,
            "rows_var": np.maximum(m2 - rad * rad, 0.0) / raw["spp"]}, seconds


def _cpu_rows_render(mode, make, stokes, spp=256):
    """:func:`_rows_render` on the CPU in ``mode`` (a :class:`CpuRenders`
    job; ``make`` a module-level function)."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    return _rows_render(make, stokes, "cpu", spp)


def _rows_pair(make, stokes, cpu, spp=256):
    """The CUDA and CPU sides of a rows gate, the CPU one from ``cpu``
    (:class:`CpuRenders`) where given, else rendered here after the CUDA
    one: (outputs by device, seconds by device, the CUDA run's launches)."""
    import eradiate_tpu_torch as etp

    out, seconds = {}, {}
    reset_launches()
    out["cuda"], seconds["cuda"] = _rows_render(make, stokes, "cuda", spp)
    launches = read_launches()
    if cpu is None:
        out["cpu"], seconds["cpu"] = _rows_render(make, stokes, "cpu", spp)
    else:
        out["cpu"], seconds["cpu"] = cpu.get(_cpu_rows_render, etp.mode().id, make, stokes, spp)
    return out, seconds, launches


def rows_cuda_vs_cpu(phase, label, make, rows, cpu=None, spp=256):
    """c1, c2 or c3 at 11 view zeniths and ``spp``, one seed, on CUDA and on
    the CPU (from ``cpu``, :class:`CpuRenders`, where given): the BRF within
    1e-4 relative and every pixel within |z| <= 5, and so each of the
    ``rows`` raw spectral rows before the CKD aggregation. Returns the CUDA
    run's launches."""
    out, seconds, launches = _rows_pair(make, False, cpu, spp)
    g, c = out["cuda"], out["cpu"]
    rel = float(np.max(np.abs(g["brf"] - c["brf"]) / np.abs(c["brf"])))
    z = _max_z(g["radiance"], c["radiance"], g["var"] + c["var"])
    rel_rows = float(np.max(np.abs(g["rows"] - c["rows"]) / np.abs(c["rows"])))
    z_rows = _max_z(g["rows"], c["rows"], g["rows_var"] + c["rows_var"])
    print(f"[{phase}] {label}, 11 VZA {spp} spp, CUDA vs CPU: max rel BRF diff {rel:.3e} (bound "
          f"1e-4), max |z| {z:.3e} (bound 5); the {g['rows'].shape[0]} raw rows: max rel "
          f"{rel_rows:.3e} (bound 1e-4), max |z| {z_rows:.3e} (bound 5); CUDA run "
          f"{seconds['cuda']:.1f} s, CPU run {seconds['cpu']:.1f} s; launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
    if g["rows"].shape != (rows, 11):
        raise AssertionError(f"{label}: {g['rows'].shape[0]} raw rows, not {rows}")
    if not (np.isfinite(g["brf"]).all() and rel <= 1e-4 and z <= 5.0 and rel_rows <= 1e-4
            and z_rows <= 5.0):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on {label}")
    return launches


def top_ops(prof, n=6):
    """The ``n`` PyTorch operators with the most device time of their own
    in a profiler window, as (name, share of the window's device time)."""
    ops = [(k, ms) for k, ms in window_records(prof)[1].items() if ms > 0]
    total = sum(t for _, t in ops) or 1.0
    return [(k, t / total) for k, t in sorted(ops, key=lambda x: -x[1])[:n]]


def rows_full_width(phase, label, exp, spp, n_vza, skip, window):
    """One full-width run of c2 or c3 with the profiler on for a window of
    ``window`` bounce iterations after ``skip`` (it warms the card), then a
    timed run: K1's launches must equal the bounce iterations summed over the
    spectral rows, and no other kernel launches. Prints wall, samples/s,
    iterations (each row's too), CUDA kernels and device time an iteration,
    the busy share, the device time by kernel family and by operator
    (``top_ops``), K1's device time a launch inside the run and the peak
    memory. Returns (launches, K1 ms a launch inside the run, iterations,
    per-row iterations, dataset, timed wall s, and a dict of the printed
    numbers as :func:`profiled_full_width` returns them)."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer

    def run():
        return etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")

    prof = profile_window(run, tracer, "collision_fetch", skip, window)
    per_it, dev_ms, shares = window_device(prof, window)
    n_rec, k1_ms = kernel_ms_in_window(prof, KERNELS["collision_fetch"], RUN_WINDOW_MIN)
    per_row = []
    saved = tracer._render_row_regen

    def counted(*args, **kwargs):
        out = saved(*args, **kwargs)
        per_row.append(out[2])
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tracer._render_row_regen = counted
    try:
        t0 = time.perf_counter()
        ds = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracer._render_row_regen = saved
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    brf = np.asarray(ds["brf"])
    samples = n_vza * spp * len(per_row)
    rows = (f"; iterations a row: min {min(per_row)}, median {statistics.median(per_row):g}, "
            f"max {max(per_row)} ({', '.join(map(str, per_row))})" if len(per_row) > 1 else "")
    print(f"[{phase}] {label} full width: {n_vza} VZA x {spp} spp x {len(per_row)} spectral "
          f"rows = {samples} samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, "
          f"{iterations} bounce iterations ({1e3 * wall / iterations:.3f} ms each){rows}; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    print(f"    launches {launches}; profiler window of {window} iterations (warm-up run): "
          f"{per_it:.1f} CUDA kernels and {dev_ms:.3f} ms of device time an iteration, busy "
          f"share {dev_ms * iterations / (1e3 * wall):.3f} of the timed run's wall; device "
          f"time by kernel family: {', '.join(f'{f} {x:.3f}' for f, x in shares.items())}; "
          f"collision_fetch {k1_ms:.4f} ms of device time a launch inside the run ({n_rec} "
          f"profiler records); operators with the most device time: "
          f"{', '.join(f'{k} {x:.3f}' for k, x in top_ops(prof))}; BRF shape {brf.shape}, "
          f"mean {brf.mean():.6f}", flush=True)
    if sum(per_row) != iterations:
        raise AssertionError(f"{label}: the rows' iterations do not sum to the run's")
    if not (launches["collision_fetch"] > 0 and launches["collision_fetch"] == iterations):
        raise AssertionError(f"{label} did not run through K1 once per bounce")
    if any(n for k, n in launches.items() if k != "collision_fetch"):
        raise AssertionError(f"{label} launched a kernel of another path")
    if brf.shape[-1] != n_vza or not np.isfinite(brf).all():
        raise AssertionError(f"{label}: BRF not finite or of the wrong shape")
    stats = {"wall_s": wall, "samples_per_s": samples / wall, "iterations": iterations,
             "kernels_an_iteration": per_it, "device_ms_an_iteration": dev_ms,
             "busy": dev_ms * iterations / (1e3 * wall), "peak_gib": peak}
    return launches, k1_ms, iterations, per_row, ds, wall, stats

def _compiled(exp):
    m = exp.measures[0]
    return exp.compile_scene(m, exp.spectral_context(m))


def _stokes_render(scene, sensor, config, spp, device):
    """``render_spherical_polarized`` at ``SEED``; (stokes [1, N, 4], I's
    variance [1, N], iterations) as numpy."""
    from eradiate_tpu_torch.ops.tracer_spherical_polarized import render_spherical_polarized

    out = render_spherical_polarized(scene, sensor, config, spp, seed=SEED, device=device)
    st, m2 = out["stokes"].cpu().numpy(), out["m2"].cpu().numpy()
    return st, (m2 - st[..., 0] ** 2) / spp, out["iterations"]


def polarized_c4_cuda_vs_cpu(phase):
    """Polarized c4 at 15 view zeniths and 256 spp on CUDA and on the CPU,
    at SZA 75, SZA 85 and as path B: the card's c4 gate on I and |z| <= 5
    on Q, U and V (I's variances); then path B against the exact-NEE render
    of the scene without its table on the card, bit for bit. Returns the
    CUDA runs' launches by form."""
    import dataclasses

    launches = {}
    for form, sza, lr in (("sza75", 75.0, False), ("sza85", 85.0, False),
                          ("path_b", 75.0, True)):
        scene, sensor, config = _compiled(_c4(sza, stokes=True))
        config = dataclasses.replace(config, lr_flight=lr)
        out, seconds = {}, {}
        for dev in ("cuda", "cpu"):
            reset_launches()
            t0 = time.perf_counter()
            out[dev] = _stokes_render(scene, sensor, config, 256, dev)
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                launches[form] = read_launches()
        (st_g, var_g, it_g), (st_c, var_c, _) = out["cuda"], out["cpu"]
        rel = np.abs(st_g[..., 0] - st_c[..., 0]) / np.abs(st_c[..., 0])
        z = max(_max_z(st_g[..., c], st_c[..., c], var_g + var_c) for c in range(4))
        mine = {"sza75": ("shell_flight",), "sza85": ("shell_event",),
                "path_b": ("shell_flight", "slant_tau")}[form]
        print(f"[{phase}] polarized c4 {form}, {N_VZA_C4} VZA 256 spp, CUDA vs CPU: max rel I "
              f"diff {rel.max():.3e}, median {np.median(rel):.3e} (bound 1e-4), pixels above "
              f"1e-4: {int((rel > 1e-4).sum())}, max |z| of I, Q, U, V {z:.3e} (bound 5); CUDA "
              f"run {seconds['cuda']:.1f} s, CPU run {seconds['cpu']:.1f} s; {it_g} event "
              f"iterations; launches {', '.join(f'{k} {n}' for k, n in launches[form].items() if n)}",
              flush=True)
        if not (np.isfinite(st_g).all() and np.median(rel) <= 1e-4 and z <= 5.0):
            raise AssertionError(f"CUDA and CPU runs of the port disagree on polarized c4 "
                                 f"({form})")
        if not all(launches[form][k] == it_g > 0 for k in mine) or any(
                n for k, n in launches[form].items() if k not in mine):
            raise AssertionError(f"polarized c4 ({form}) did not launch {mine} once per event")
    scene, sensor, config = _compiled(_c4(75.0, stokes=True))
    lr = _stokes_render(scene, sensor, dataclasses.replace(config, lr_flight=True), 256, "cuda")
    scene_x, sensor_x, config_x = _compiled(_c4(75.0, sun_tau_table=False, stokes=True))
    if scene_x.medium.sun_tau is not None:
        raise AssertionError("the sun-tau table is still on")
    exact = _stokes_render(scene_x, sensor_x, config_x, 256, "cuda")
    same = np.array_equal(lr[0].view(np.int32), exact[0].view(np.int32)) and lr[2] == exact[2]
    print(f"    path B against the exact-NEE render (shell_event) on the card: Stokes and "
          f"iterations bit for bit equal: {same} ({lr[2]} and {exact[2]} iterations)", flush=True)
    if not same:
        raise AssertionError("polarized path B and the exact-NEE render differ on the card")
    return launches


def polarized_c4_full_width(phase, scalar_brf, skip=64, window=48):
    """Polarized c4 at SZA 75 at full width (:data:`SPP_C4_POLARIZED`), in
    the reference's chunks: a
    warm-up run with the profiler on for ``window`` event iterations after
    ``skip``, then a timed run; K2's launches must equal the event
    iterations summed over the chunks, and no other kernel launches.
    Returns (launches, K2's device ms a launch inside the run)."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer_spherical, tracer_spherical_polarized as tsp
    from eradiate_tpu_torch.ops.tracer import MAX_PATHS_PER_DISPATCH, chunk_plan

    exp = _c4(75.0, stokes=True)

    def run():
        return etp.run(exp, spp=SPP_C4_POLARIZED, seed_state=etp.SeedState(SEED), device="cuda")

    prof = profile_window(run, tracer_spherical, "shell_flight", skip, window)
    per_it, dev_ms, shares = window_device(prof, window)
    n_rec, k2_ms = kernel_ms_in_window(prof, KERNELS["shell_flight"], RUN_WINDOW_MIN)
    per_chunk = []
    saved = tsp._render_row

    def counted(*args, **kwargs):
        out = saved(*args, **kwargs)
        per_chunk.append(out[2])
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tsp._render_row = counted
    try:
        t0 = time.perf_counter()
        ds = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tsp._render_row = saved
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = chunk_plan(SPP_C4_POLARIZED, None, 1, N_VZA_C4, MAX_PATHS_PER_DISPATCH)
    samples = N_VZA_C4 * SPP_C4_POLARIZED
    I, q, dolp, vza = _nadir(ds)
    brf = np.asarray(ds["brf"])
    print(f"[{phase}] polarized c4 SZA 75 full width: {N_VZA_C4} VZA x {SPP_C4_POLARIZED} spp = {samples} "
          f"samples in {len(per_chunk)} chunks ({chunks[0]} spp, the last {chunks[-1]}), wall "
          f"{wall:.3f} s, {samples / wall:.4e} samples/s, {iterations} event iterations "
          f"({1e3 * wall / iterations:.3f} ms each); iterations a chunk: "
          f"{', '.join(map(str, per_chunk))}; peak device memory {peak:.2f} GiB", flush=True)
    print(f"    launches {launches}; profiler window of {window} iterations (warm-up run): "
          f"{per_it:.1f} CUDA kernels and {dev_ms:.3f} ms of device time an iteration, busy "
          f"share {dev_ms * iterations / (1e3 * wall):.3f} of the timed run's wall; device "
          f"time by kernel family: {', '.join(f'{f} {x:.3f}' for f, x in shares.items())}; "
          f"operators with the most device time: "
          f"{', '.join(f'{k} {x:.3f}' for k, x in top_ops(prof))}; shell_flight {k2_ms:.4f} "
          f"ms of device time a launch inside the run ({n_rec} profiler records)", flush=True)
    print(f"    at VZA {vza:.2f}: I {I:.6e}, Q/I {q:.6f}, DoLP {dolp:.6f}, BRF {brf[0, 8]:.6f} "
          f"(the scalar run's, phase 9: {scalar_brf:.6f})", flush=True)
    if len(per_chunk) != len(chunks) or sum(per_chunk) != iterations:
        raise AssertionError("polarized c4: the chunks' iterations do not sum to the run's")
    if not (launches["shell_flight"] > 0 and launches["shell_flight"] == iterations):
        raise AssertionError("polarized c4 did not run through K2 once per event")
    if any(n for k, n in launches.items() if k != "shell_flight"):
        raise AssertionError("polarized c4 launched a kernel of another path")
    stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
    if stokes.shape != (1, N_VZA_C4, 4) or not np.isfinite(stokes).all() or not (
            stokes[..., 0] > 0).all():
        raise AssertionError("polarized c4: Stokes vectors not finite, positive or shaped")
    return launches, k2_ms


def polarized_rows_cuda_vs_cpu(phase, cpu=None):
    """c3 in ``ckd_polarized_single`` at 11 view zeniths and
    :data:`C3_GATE_SPP` a row at 2 g-points a bin (:func:`_c3_gate`), one
    seed, on CUDA and on the CPU (from ``cpu`` where given): each of the
    14 raw rows' I within 1e-4 relative and every Stokes component within
    |z| <= 5 (the rows' I variances), and so the aggregated I; K1's launches
    must equal the bounce iterations summed over the rows, and no other
    kernel launches. Returns the CUDA run's launches."""
    out, seconds, launches = _rows_pair(_c3_gate, True, cpu, C3_GATE_SPP)
    g, c = out["cuda"], out["cpu"]
    iterations = g["iterations"]
    rel_rows = float(np.max(np.abs(g["rows"][..., 0] - c["rows"][..., 0]) / c["rows"][..., 0]))
    z = max(_max_z(g["rows"][..., k], c["rows"][..., k], g["var"] + c["var"]) for k in range(4))
    rel = float(np.max(np.abs(g["I"] - c["I"]) / np.abs(c["I"])))
    print(f"[{phase}] c3 (ckd_polarized_single, 2 g-points a bin), 11 VZA {C3_GATE_SPP} spp, "
          "CUDA vs CPU: the "
          f"{g['rows'].shape[0]} raw rows: max rel I diff {rel_rows:.3e} (bound 1e-4), max |z| "
          f"of I, Q, U, V {z:.3e} (bound 5); aggregated I (bins {g['I'].shape[0]}): max rel "
          f"{rel:.3e} (bound 1e-4); CUDA run {seconds['cuda']:.1f} s, CPU run "
          f"{seconds['cpu']:.1f} s; {iterations} bounce iterations; launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
    if g["rows"].shape != (C3_GATE_ROWS, 11, 4):
        raise AssertionError(f"polarized c3: raw Stokes of shape {g['rows'].shape}")
    if not (np.isfinite(g["rows"]).all() and rel_rows <= 1e-4 and z <= 5.0 and rel <= 1e-4):
        raise AssertionError("CUDA and CPU runs of the port disagree on polarized c3")
    if not (launches["collision_fetch"] > 0 and launches["collision_fetch"] == iterations):
        raise AssertionError("polarized c3 did not run through K1 once per bounce")
    if any(n for k, n in launches.items() if k != "collision_fetch"):
        raise AssertionError("polarized c3 launched a kernel of another path")
    return launches


# ---- float64 builds and the double modes (phases 32-37) ----------------------


def _f64(args):
    """Shell-kernel operands taken exactly into float64."""
    return tuple(a.double().contiguous() for a in args)


def _shell_inputs_f64(exp, B, seed, device="cuda"):
    """``_shell_inputs`` of ``exp`` compiled in the double mode that is set,
    every operand in float64 and the flight caps recomputed from the float64
    lanes, as the tracer computes them."""
    import torch

    from eradiate_tpu_torch.ops.tracer_spherical import flight_bounds

    p, d, _, radii, sigma, tau_s, w_sun = _f64(_shell_inputs(exp, B, seed, device=device))
    t_ground, t_exit = flight_bounds(p, d, radii)
    return p, d, torch.minimum(t_ground, t_exit).contiguous(), radii, sigma, tau_s, w_sun


def _flight_levels_f64(args, layer):
    """The levels a float64 flight lane has to read, whatever implements it:
    from its tangent level to the highest of its brackets of |x0|, |x_max|
    and the sampled depth (``layer``), as ``test_tools.shells.flight_levels``
    counts them for the float32 kernels."""
    import torch

    from eradiate_tpu_torch.ops.spherical import cross_norm2, dot3

    p, d, t_max, radii, _, _, _ = args
    L = radii.shape[0] - 1
    x0 = dot3(p, d)
    b2 = cross_norm2(p, d)
    r2 = radii * radii
    X = torch.sqrt(torch.clamp(r2[:, None] - b2, min=0.0))

    def bracket(y):
        return torch.clamp((X <= y).sum(0) - 1, 0, L - 1)

    top = torch.maximum(torch.maximum(bracket(x0.abs()), bracket((x0 + t_max).abs())),
                        layer.long())
    tangent = torch.clamp((r2[:, None] <= b2).sum(0) - 1, 0, L - 1)
    return torch.clamp(top - tangent + 1, min=1)


def check_shell_kernels_f64(name, args, timed=False):
    """K2, K3 and K4's float64 builds against their twins on the card, bit
    pattern for bit pattern (``args`` float64, as ``_shell_inputs`` orders
    them); K4 at K2's event points must equal K3's tau_sun. Returns (max abs
    errors, times, bounds) by kernel, as ``check_shell_kernels``. The
    bound: the lanes' state and the column read once, the outputs written
    once; ~10 float64 operations (a square root among them) for each level
    a flight has to read (``_flight_levels_f64``) and ~15 (two roots and a
    quotient among them) for each distinct segment of the slant path from
    the event point (``test_tools.shells.crossed_segments``), over the card's
    float64 rate. Fails where a lane passes more than L + S levels in the
    kernels' emulation (``_flight_stats``), as ``check_shell_kernels``."""
    import torch

    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import fma
    from eradiate_tpu_torch.test_tools.shells import crossed_segments

    p, d, t_max, radii, sigma, _, w_sun = args
    flight_args = args[:6]
    flight = _flight_stats(args)
    if flight["most"] > flight["L"] + flight["S"]:
        raise AssertionError(f"{name}: an emulated float64 lane passes {flight['most']:.0f} "
                             "levels, above L + S")
    collide, t_col, layer = sf.shell_flight(*flight_args)
    p_event = fma(d, torch.where(collide, t_col, t_max)[:, None], p).contiguous()
    levels = _flight_levels_f64(args, layer)
    segments = crossed_segments(p_event, w_sun, radii)
    checks = {
        "shell_flight": (sf.shell_flight, sf.shell_flight_plain, flight_args),
        "slant_tau": (lambda *a: (sf.slant_tau(*a),), lambda *a: (sf.slant_tau_exact(*a),),
                      (p_event, w_sun, radii, sigma)),
        "shell_event": (sf.shell_event, sf.shell_event_plain, args),
    }
    errs, times, bounds = {}, {}, {}
    for kernel, (fn, plain, a) in checks.items():
        got, want = fn(*a), plain(*a)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(_bits(g), _bits(w)):
                raise AssertionError(f"{name}: {kernel} (float64) differs from the twin on "
                                     f"{int((_bits(g) != _bits(w)).sum())} lanes")
        errs[kernel] = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        if timed:
            device, by = _device_ms(lambda: fn(*a), KERNELS[kernel + "_f64"])
            times[kernel] = {"ms": _time_ms(lambda: fn(*a)), "device_ms": device,
                             "device_by": by, "plain_ms": _time_ms(lambda: plain(*a), reps=5)}
            n_bytes = sum(t.numel() * t.element_size() for t in tuple(a) + tuple(got))
            flops = 40.0 * a[0].shape[0]
            if kernel != "slant_tau":
                flops += 10.0 * float(levels.sum())
            if kernel != "shell_flight":
                flops += 15.0 * float(segments.sum())
            bounds[kernel] = bound_ms(n_bytes, flops, PEAK_F64_FLOPS)
        if kernel == "slant_tau":
            tau_k4 = got[0]
    if not torch.equal(_bits(tau_k4), _bits(got[3])):
        raise AssertionError(f"{name}: slant_tau_f64 at the event points differs from "
                             "shell_event_f64")
    line = (f"  {name}: B={p.shape[0]} L={sigma.shape[0]} float64: collide, t_col, layer, "
            f"tau_sun, tau bit for bit for the three float64 builds (0 lanes differ), K4 equal "
            f"to K3's tau_sun (collide share {collide.double().mean().item():.3f}, TAU_BLOCKED "
            f"share {(got[3] >= 1e9).double().mean().item():.3f}); levels a flight reads "
            f"{levels.double().mean().item():.2f}, crossed segments a lane "
            f"{segments.double().mean().item():.2f}; " + _flight_line(flight))
    for kernel, t in times.items():
        line += (f"; {kernel}_f64 kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} by the "
                 f"{t['device_by']}), twin {t['plain_ms']:.4f} ms, bound "
                 f"{bounds[kernel][0]:.4f} ms by {bounds[kernel][1]}")
    print(line, flush=True)
    return errs, times, bounds


def double_pixels_gate(phase, label, make, mode, spp, n_vza):
    """The port on CUDA against the port on the CPU in a double mode, one
    seed: every raw pixel's radiance and second moment within 1e-10
    relative (Q, U and V within 1e-10 of I with Stokes output) and every
    pixel within |z| <= 5. Returns the CUDA run's launches."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    raw, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        exp = make(n_vza)
        reset_launches()
        t0 = time.perf_counter()
        ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device=dev)
        seconds[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches = read_launches()
        raw[dev] = {k: np.asarray(v) for k, v in exp.measures[0].results["raw"].items()
                    if not np.isscalar(v)}
        raw[dev]["brf"] = np.asarray(ds["brf"])
    g, c = raw["cuda"], raw["cpu"]
    rel = {k: float(np.max(np.abs(g[k] - c[k]) / np.abs(c[k]))) for k in ("radiance", "m2")}
    I = np.abs(c["radiance"])
    if "stokes" in c:
        rel["stokes"] = float(np.max(np.abs(g["stokes"] - c["stokes"]) / I[..., None]))
    var = 2.0 * np.maximum(c["m2"] - c["radiance"] ** 2, 0.0) / spp
    z = _max_z(g["radiance"], c["radiance"], var)
    print(f"[{phase}] {label} ({mode}), {n_vza} VZA {spp} spp, CUDA vs CPU: dtype "
          f"{g['radiance'].dtype}, max rel " + ", ".join(f"{k} {x:.3e}" for k, x in rel.items())
          + f" (bound 1e-10; Stokes against I), max |z| {z:.3e} (bound 5); CUDA run "
          f"{seconds['cuda']:.1f} s, CPU run {seconds['cpu']:.1f} s; launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
    if g["radiance"].dtype != np.float64 or not np.isfinite(g["brf"]).all():
        raise AssertionError(f"{label} in {mode}: not float64 or not finite")
    if max(rel.values()) > 1e-10 or z > 5.0:
        raise AssertionError(f"CUDA and CPU runs of the port disagree on {label} in {mode}")
    return launches


def profiled_full_width(phase, label, make, mode, spp, n_vza, module, attr, key, skip, window):
    """A full-width run in ``mode`` with the profiler on for ``window``
    iterations of ``module.attr`` (called once an iteration) after ``skip``,
    ended there, then a timed run: the launches of the wrapper ``key`` (or
    of each of a tuple of them) must equal the iterations, and no other
    kernel launch. Prints wall, samples/s, ms an iteration, CUDA kernels and
    device ms an iteration, the busy share (device time an iteration times
    the iterations over the timed wall), the device time by kernel family,
    each key's device ms a launch in the window, the peak memory and the
    BRF at the middle view. Returns a dict of them (``launches`` and
    ``run_device_ms`` by key for a tuple)."""
    import torch

    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    exp = make(n_vza)

    def run():
        return etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")

    keys = (key,) if isinstance(key, str) else key
    prof = profile_window(run, module, attr, skip, window)
    per_it, dev_ms, shares = window_device(prof, window)
    k_ms = {k: kernel_ms_in_window(prof, KERNELS[k], window // 2)[1] for k in keys}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    rows = np.asarray(exp.measures[0].results["raw"]["radiance"]).shape[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    brf = np.asarray(ds["brf"])
    samples = n_vza * spp * rows
    busy = dev_ms * iterations / (1e3 * wall)
    middle = float(brf[0, brf.shape[-1] // 2])
    print(f"[{phase}] {label} ({mode}) full width: {n_vza} VZA x {spp} spp x {rows} rows = "
          f"{samples} samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, {iterations} "
          f"iterations ({1e3 * wall / iterations:.3f} ms each), peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"    launches {', '.join(f'{k} {n}' for k, n in launches.items() if n)}; profiler "
          f"window of {window} iterations (warm-up run): {per_it:.1f} CUDA kernels and "
          f"{dev_ms:.3f} ms of device time an iteration, busy share {busy:.3f}; by kernel "
          f"family: {', '.join(f'{f} {x:.3f}' for f, x in shares.items())}; "
          f"{', '.join(f'{k} {ms:.4f} ms' for k, ms in k_ms.items())} a launch inside the run; "
          f"BRF {brf.dtype}, shape {brf.shape}, mean {brf.mean():.6f}, at the middle view "
          f"{middle:.6f}", flush=True)
    if not all(launches[k] > 0 and launches[k] == iterations for k in keys):
        raise AssertionError(f"{label} in {mode} did not launch {keys} once an iteration")
    if any(n for k, n in launches.items() if k not in keys):
        raise AssertionError(f"{label} in {mode} launched a kernel of another path")
    if not np.isfinite(brf).all():
        raise AssertionError(f"{label} in {mode}: BRF not finite")
    one = isinstance(key, str)
    return {"wall_s": wall, "samples_per_s": samples / wall, "iterations": iterations,
            "kernels_an_iteration": per_it, "device_ms_an_iteration": dev_ms, "busy": busy,
            "peak_gib": peak, "launches": launches[key] if one else launches,
            "run_device_ms": k_ms[key] if one else k_ms, "brf_mean": float(brf.mean()),
            "brf_middle": middle}


def path_b_double(phase, spp):
    """c4 at SZA 75 with ``lr_flight`` in ``mono_double`` on the card at
    ``spp``: K2's and K4's float64 builds launched once an event each, and
    the radiance and iterations equal, bit for bit, to the exact-NEE render
    (K3's float64 build) of the same scene; then one more ``lr_flight`` run
    with CUDA events around each launch. Returns the launches and
    ({wrapper: (launches, device ms a launch)}) of that run."""
    import dataclasses

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops.tracer_spherical import render_spherical

    etp.set_mode("mono_double")
    scene, sensor, config = _compiled(_c4(75.0))
    out = {}
    for lr in (True, False):
        reset_launches()
        t0 = time.perf_counter()
        r = render_spherical(scene, sensor, dataclasses.replace(config, lr_flight=lr), spp,
                             seed=SEED, device="cuda")
        out[lr] = (r["radiance"].cpu().numpy(), r["iterations"], read_launches(),
                   time.perf_counter() - t0)
    (rad, it, launches, wall), (rad_x, it_x, launches_x, wall_x) = out[True], out[False]
    same = bool(np.array_equal(rad.view(np.int64), rad_x.view(np.int64))) and it == it_x
    samples = N_VZA_C4 * spp
    print(f"[{phase}] c4 SZA 75 path B (lr_flight, mono_double), {N_VZA_C4} VZA x {spp} spp on "
          f"the card: wall {wall:.3f} s ({samples / wall:.4e} samples/s; the exact-NEE render "
          f"{wall_x:.3f} s), {it} event iterations, launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}; radiance and iterations "
          f"bit for bit with the exact-NEE render ({launches_x['shell_event_f64']} "
          f"shell_event_f64 launches): {same}", flush=True)
    if not (launches["shell_flight_f64"] == launches["slant_tau_f64"] == it > 0):
        raise AssertionError("path B in mono_double did not launch K2 and K4 once an event")
    if any(n for k, n in launches.items() if k not in ("shell_flight_f64", "slant_tau_f64")):
        raise AssertionError("path B in mono_double launched a kernel of another path")
    if not same:
        raise AssertionError("path B in mono_double differs from the exact-NEE render")
    config_lr = dataclasses.replace(config, lr_flight=True)
    in_run, _, _ = launch_ms_in_run(
        lambda: render_spherical(scene, sensor, config_lr, spp, seed=SEED, device="cuda"),
        ("shell_flight", "slant_tau"), starts=False)
    _print_in_run(in_run)
    return launches, in_run


def canopy_double_phases(B5, single_times, pol_single, ds_pol_single, c5_single, cpu):
    """Phases 38-40, the leaf canopy in the double modes through the float64
    builds of K5, K6 and K7 (``B5``: the c5 path's lane count;
    ``single_times``: phase 11's times of the float32 kernels;
    ``pol_single``: phase 23's numbers of polarized c5 in
    ``mono_polarized_single``, ``ds_pol_single`` its dataset; ``c5_single``:
    phases 13 and 14's walls and BRF at nadir by form; ``cpu``: the
    :class:`CpuRenders` of the CPU runs). Returns the four
    float64 sweeps' errors, times, bounds, reach, launches on their paths
    and launches and device times on the other double paths."""
    import torch

    import eradiate_tpu_torch as etp

    etp.set_mode("mono_double")
    print("[38] leaf-sweep kernels' float64 builds against their float64 plain versions: "
          "leaf_bvh_nearest_f64_kernel, leaf_bvh_occluded_f64_kernel (flat), "
          "leaf_ibvh_nearest_f64_kernel, leaf_ibvh_occluded_f64_kernel (instanced)", flush=True)
    errs, times, bounds, reach = {}, {}, {}, {}
    f64 = np.float64
    for form in ("flat", "instanced"):
        exp = _c5(form)
        leaves, cull, rays, *_ = _canopy_inputs(exp, B5, seed=60)
        if rays[0].dtype != torch.float64:
            raise AssertionError("the c5 scene did not compile float64 leaves in mono_double")
        form_errs, t, b, r = check_sweep_kernels(
            f"HET01 {form} in float64, the path's lane count", leaves, cull, rays, seed=60,
            timed=True, plain_lanes=2**16)
        times.update(t)
        bounds.update(b)
        reach.update(r)
        inst = form == "instanced"
        stress = _instanced_stress_inputs if inst else _leaf_stress_inputs
        cases = [
            (f"HET01 {form} in float64, ragged", lambda: _canopy_inputs(exp, 50_021, 61)[:3]),
            (f"HET01 {form} in float64, rays beside the box",
             lambda: _canopy_inputs(exp, 2**15, 61, miss=True)[:3]),
            (f"random disks {form} in float64, rays at the rims from 0.5-3 units",
             lambda: _rim_inputs(inst, 2**16, 62, dtype=f64)),
            (f"random disks {form} in float64, rays at the rims from 50-300 units",
             lambda: _rim_inputs(inst, 2**16, 63, far=True, dtype=f64)),
            (f"random disks {form} in float64 with normal components of +-0, rays at the rims",
             lambda: _rim_inputs(inst, 2**16, 64, zero_normals=True, dtype=f64)),
            (f"float64 tie table {form}: exact two-, three- and four-way ties inside a chunk, "
             "ties across chunks" + (" and across instances" if inst else ""),
             lambda: stress("ties", 2**16, 65, dtype=f64)),
            (f"random disks {form} in float64, zero direction components, from 0.5-3 units",
             lambda: stress("axes near", 2**16, 66, dtype=f64)),
            (f"random disks {form} in float64, zero direction components, from 50-300 units",
             lambda: stress("axes far", 2**16, 67, dtype=f64)),
            (f"random disks {form} in float64, grazing incidence",
             lambda: stress("grazing", 2**16, 68, dtype=f64)),
        ]
        if inst:
            cases.append(("random disks instanced in float64 200 units from the world origin, "
                          "rays from near it", lambda: stress("far offsets", 2**16, 69, dtype=f64)))
        for label, make in cases:
            more, *_ = check_sweep_kernels(label, *make(), seed=61, plain_lanes=2**16)
            form_errs = {k: max(v, more[k]) for k, v in form_errs.items()}
        errs.update(form_errs)
    for k, t in times.items():
        one = single_times[k[: -len("_f64")]]
        print(f"    {k}: device {t['device_ms']:.4f} ms against the float32 kernel's "
              f"{one['device_ms']:.4f} ms ({t['device_ms'] / one['device_ms']:.2f}x), call "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms at {t['plain_lanes']} lanes, "
              f"bound {bounds[k][0]:.4f} ms by {bounds[k][1]} (float64 rate)", flush=True)

    # -- 39. c5 as bench.py builds it, in mono_polarized ------------------------
    etp.set_mode("mono_polarized")
    pol_launches, pol_ms, pol = polarized_c5_full_width(
        39, ds_pol_single, "_f64", "mono_polarized_single's, phase 23")
    pol.pop("ds")
    print(f"     c5 in mono_polarized (float64 path state on the card; bench.py's "
          f"mono_polarized is float32 path state on a TPU) against mono_polarized_single "
          f"(phase 23) in this run: wall {pol['wall_s']:.3f} s against "
          f"{pol_single['wall_s']:.3f} s ({pol['wall_s'] / pol_single['wall_s']:.3f}x), "
          f"samples/s {pol['samples_per_s']:.4e} against {pol_single['samples_per_s']:.4e}, "
          f"iterations {pol['iterations']} against {pol_single['iterations']}, kernels an "
          f"iteration {pol['kernels_an_iteration']:.1f} against "
          f"{pol_single['kernels_an_iteration']:.1f}, device ms an iteration "
          f"{pol['device_ms_an_iteration']:.3f} against {pol_single['device_ms_an_iteration']:.3f}, "
          f"busy {pol['busy']:.3f} against {pol_single['busy']:.3f}, peak "
          f"{pol['peak_gib']:.2f} against {pol_single['peak_gib']:.2f} GiB", flush=True)

    # -- 40. mono_double at full width; double against the CPU at 64 spp -------
    from eradiate_tpu_torch.ops import tracer_canopy

    runs = {form: profiled_full_width(
        40, f"c5 scene ({form})", lambda n, form=form: _c5(form), "mono_double", SPP_C5,
        N_VZA_C5, tracer_canopy, "leaf_nearest",
        tuple(k + "_f64" for k in C5_KERNELS[form]), 20, 40) for form in ("flat", "instanced")}
    for form, run in runs.items():
        one = c5_single[form]
        print(f"     c5 ({form}) in mono_double against mono_single (phase "
              f"{13 if form == 'instanced' else 14}): wall {run['wall_s']:.3f} s against "
              f"{one['wall_s']:.3f} s ({run['wall_s'] / one['wall_s']:.3f}x), BRF at nadir "
              f"{run['brf_middle']:.6f} against {one['brf_nadir']:.6f}", flush=True)
    small = {}
    for form in ("instanced", "flat"):
        small[form] = c5_cuda_vs_cpu(form, 40, cpu)
    etp.set_mode("mono_polarized_double")
    small["polarized"] = c5_cuda_vs_cpu("instanced", 40, cpu, stokes=True)
    etp.set_mode("mono_single")
    launches = {"ray_leaves_nearest_f64": runs["flat"]["launches"]["ray_leaves_nearest_f64"],
                "ray_leaves_occluded_f64": runs["flat"]["launches"]["ray_leaves_occluded_f64"],
                **{k: pol_launches[k] for k in ("ray_leaves_nearest_instanced_f64",
                                                "ray_leaves_occluded_instanced_f64")}}
    other = {"c5_mono_double_instanced": runs["instanced"]["launches"],
             **{f"c5_64spp_{k}": v for k, v in small.items()}}
    extra = {k: {"launches_on": {path: counts[k] for path, counts in other.items()
                                 if counts.get(k)},
                 "run_device_ms": {**{f: runs[f]["run_device_ms"][k] for f in runs
                                      if k in runs[f]["run_device_ms"]},
                                   **({"c5_mono_polarized": pol_ms[k]} if k in pol_ms else {})}}
             for k in launches}
    return {"errs": errs, "times": times, "bounds": bounds, "reach": reach,
            "launches": launches, "extra": extra, "pol": pol, "runs": runs}


#: The float64 builds of the triangle sweeps, by the form of the c5 scene
#: whose path launches them.
TRI_F64 = {form: tuple(k + "_f64" for k in C5_KERNELS[form] if k.startswith("ray_tris"))
           for form in ("trees", "wood")}


def tri_double_phases(B5, single_times, tri_single, cpu):
    """Phases 41-43, canopies with triangles in the double modes through the
    float64 builds of K8 and K9 (``B5``: the c5 path's lane count;
    ``single_times``: phase 16's times of the float32 kernels;
    ``tri_single``: phases 18 and 19's walls and BRF at nadir by form;
    ``cpu``: the :class:`CpuRenders` of the CPU runs). Returns the four
    float64 triangle sweeps' errors, times, bounds, reach, skeleton times,
    launches on their paths and launches and device times on the other
    double paths."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels.tri_intersect import tri_bvh, tri_instanced_bvh
    from eradiate_tpu_torch.ops import tracer_canopy

    f64 = np.float64
    etp.set_mode("mono_double")
    print("[41] triangle-sweep kernels' float64 builds against their float64 plain versions: "
          "bvh_nearest_f64_kernel, bvh_occluded_f64_kernel (flat), tri_ibvh_nearest_f64_kernel, "
          "tri_ibvh_occluded_f64_kernel (instanced)", flush=True)
    errs, times, bounds, reach = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as mesh_dir:
        for form, plain_lanes in (("trees", 2**16), ("wood", 2**14)):
            exp = _c5(form, mesh_dir)
            *_, tris, cull, rays = _canopy_inputs(exp, B5, seed=70)
            if rays[0].dtype != torch.float64:
                raise AssertionError(f"c5_{form} did not compile float64 triangles in mono_double")
            if form == "wood":
                check_rebuild("c5_wood in float64", cull,
                              lambda: tri_bvh(tris.v0, tris.e1, tris.e2))
            else:
                trunks = tris
                check_rebuild("c5_trees trunks in float64", cull, lambda: tri_instanced_bvh(
                    trunks.canonical.v0, trunks.canonical.e1, trunks.canonical.e2,
                    trunks.offsets))
            form_errs, t, b, r = check_sweep_kernels(
                f"c5_{form} in float64, the path's lane count", tris, cull, rays, seed=70,
                timed=True, plain_lanes=plain_lanes)
            times.update(t)
            bounds.update(b)
            reach.update(r)
            inst = form == "trees"
            # the float64 plain sweep of 92700 triangles runs on every lane
            # of these: fewer lanes for the wood (16,411 and 2^13 before)
            ragged, beside = (50_021, 2**15) if inst else (4_099, 2**12)
            cases = [
                (f"c5_{form} in float64, ragged ({ragged} lanes)",
                 lambda: _canopy_inputs(exp, ragged, 71)[3:]),
                (f"c5_{form} in float64, rays beside the box",
                 lambda: _canopy_inputs(exp, beside, 71, miss=True)[3:]),
            ]
            kind = "instanced" if inst else "flat"
            for far, label in ((False, "0.5-3 m"), (True, "50-300 m")):
                cases += [
                    (f"wood skeleton {kind} in float64, rays at edges and vertices from {label}",
                     lambda far=far: _edge_inputs(inst, 2**15, 72, far, dtype=f64)),
                    (f"wood skeleton {kind} in float64, rays exactly at its vertices (cap apexes "
                     f"of 12 and 8 triangles, side vertices of 6) from {label}",
                     lambda far=far: _edge_inputs(inst, 2**15, 73, far, dtype=f64,
                                                  vertices=True)),
                ]
            if not inst:
                cases += [
                    ("float64 tie soup, exact ties inside a chunk and across (the walk meets "
                     "the higher chunk first)",
                     lambda: _flat_stress_inputs("ties", 2**16, 74, dtype=f64)),
                    ("wood skeleton flat in float64, zero direction components, from 0.5-3 m",
                     lambda: _flat_stress_inputs("axes near", 2**16, 75, dtype=f64)),
                    ("wood skeleton flat in float64, zero direction components, from 50-300 m",
                     lambda: _flat_stress_inputs("axes far", 2**16, 76, dtype=f64)),
                ]
            else:
                cases += [
                    (f"float64 instanced tie soup, exact ties inside a chunk, across chunks and "
                     f"across instances (the walk meets the higher instance first)",
                     lambda: _instanced_tri_stress_inputs("ties", 2**16, 74, dtype=f64)),
                    ("c5_trees trunks in float64, rays exactly at their vertices",
                     lambda: _instanced_tri_stress_inputs("vertices", 2**16, 75, trunks, f64)),
                    ("c5_trees trunks in float64, zero direction components, from 0.5-3 m",
                     lambda: _instanced_tri_stress_inputs("axes near", 2**16, 76, trunks, f64)),
                    ("c5_trees trunks in float64, zero direction components, from 50-300 m",
                     lambda: _instanced_tri_stress_inputs("axes far", 2**16, 77, trunks, f64)),
                    ("c5_trees trunks in float64 2 km from the world origin, rays from near it",
                     lambda: _instanced_tri_stress_inputs("far offsets", 2**16, 78, trunks, f64)),
                ]
            for label, make in cases:
                more, *_ = check_sweep_kernels(label, *make(), seed=71, plain_lanes=2**16)
                form_errs = {k: max(v, more[k]) for k, v in form_errs.items()}
            errs.update(form_errs)
        skeleton = instanced_against_flat(_c5("wood", mesh_dir), B5, 70, mesh_dir,
                                          plain_lanes=2**13, dtype=f64)
        for k, t in times.items():
            one = single_times[k[: -len("_f64")]]
            print(f"    {k}: device {t['device_ms']:.4f} ms against the float32 kernel's "
                  f"{one['device_ms']:.4f} ms ({t['device_ms'] / one['device_ms']:.2f}x), call "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms at {t['plain_lanes']} lanes, "
                  f"reach {reach.get(k, 'not measured')}, bound {bounds[k][0]:.4f} ms by "
                  f"{bounds[k][1]} (float64 rate)", flush=True)

        # -- 42. c5_trees and c5_wood in mono_double at full width ------------
        runs = {form: profiled_full_width(
            42, f"c5_{form}", lambda n, form=form: _c5(form, mesh_dir), "mono_double", SPP_C5,
            N_VZA_C5, tracer_canopy, "leaf_nearest",
            tuple(k + "_f64" for k in C5_KERNELS[form]), 20, 40) for form in ("trees", "wood")}
        for form, run in runs.items():
            one = tri_single[form]
            print(f"     c5_{form} in mono_double against mono_single (phase "
                  f"{18 if form == 'trees' else 19}): wall {run['wall_s']:.3f} s against "
                  f"{one['wall_s']:.3f} s ({run['wall_s'] / one['wall_s']:.3f}x), samples/s "
                  f"{run['samples_per_s']:.4e}, BRF at nadir {run['brf_middle']:.6f} against "
                  f"{one['brf_nadir']:.6f}; "
                  + ", ".join(f"{k} {run['run_device_ms'][k]:.4f} ms" for k in TRI_F64[form])
                  + " of device time a launch inside the run", flush=True)

        # -- 43. CUDA against the CPU at 64 spp ----------------------------------
        small = {"trees": c5_cuda_vs_cpu("trees", 43, cpu),
                 "wood": c5_cuda_vs_cpu("wood", 43, cpu, mesh_dir, branches=12)}
        etp.set_mode("mono_polarized_double")
        small["trees_polarized"] = c5_cuda_vs_cpu("trees", 43, cpu, stokes=True)
    etp.set_mode("mono_single")
    launches = {k: runs[form]["launches"][k] for form, keys in TRI_F64.items() for k in keys}
    extra = {k: {"launches_on": {f"c5_{form}_64spp": n for form, counts in small.items()
                                 if (n := counts.get(k))},
                 "run_device_ms": {f"c5_{form}": runs[form]["run_device_ms"][k]
                                   for form in runs if k in runs[form]["run_device_ms"]}}
             for k in launches}
    return {"errs": errs, "times": times, "bounds": bounds, "reach": reach,
            "skeleton": skeleton, "launches": launches, "extra": extra, "runs": runs}


def double_phases(fetch_times, B4, sun_85, c3_wall):
    """Phases 32-37, the double modes through the float64 builds of K1-K4
    (``fetch_times``: phase 3's K1 times; ``B4``: c4's lane count; ``sun_85``:
    the SZA 85 sun; ``c3_wall``: phase 27's c3 wall in ``ckd_single``).
    Returns the full-width runs by (config, mode), path B's launches, the
    polarized c1 run's launches, and K1's and K2-K4's (errors, times,
    bounds)."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops.tracer import REGEN_LANES_TARGET, lane_partition
    from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools
    from eradiate_tpu_torch.test_tools import shells

    from eradiate_tpu_torch.ops import tracer as pp_tracer
    from eradiate_tpu_torch.ops import tracer_spherical as sph_tracer

    etp.set_mode("mono_double")
    print("[32] collision_fetch float64 build against its plain twin", flush=True)
    B1 = N_VZA * lane_partition(N_VZA, SPP_C1, REGEN_LANES_TARGET["cuda"], "cpu")[0]
    c1_column64 = fetch_tools.column_operands(dtype=np.float64)
    err64, fetch64_times, fetch64_bound = check_collision_fetch(
        "c1 merged column, mono_double", c1_column64, B1, seed=50, timed=True)
    rng = np.random.default_rng(51)
    cases64 = [
        ("c1 merged column, mono_double, ragged", c1_column64, B1 + 37, 0),
        ("c1 merged column, mono_double, queries from a q[1:] view", c1_column64, B1, 1),
        ("unmerged 1200-layer column, mono_double",
         fetch_tools.column_operands(None, dtype=np.float64), 2**20 + 3, 0),
        ("7-layer table with flat runs, float64", fetch_tools.flat_run_operands(dtype=np.float64),
         2**20 + 1, 0),
    ]
    for L, K in ((1, 3), (12287, 1), (46, 16)):
        dtau = rng.uniform(0.0, 1.0, L) * (rng.uniform(size=L) > 0.2)
        column = (np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 1.0, L))]),
                  np.concatenate([[0.0], np.cumsum(dtau)]), rng.uniform(size=(K, L)))
        cases64.append((f"random column, L = {L}, K = {K}, float64", column, 2**20 + 3, 0))
    for i, (label, column, lanes, offset) in enumerate(cases64):
        more, *_ = check_collision_fetch(label, column, lanes, seed=52 + i, offset=offset)
        err64 = max(err64, more)
    print(f"    float64 build at L = 46: device {fetch64_times['device_ms']:.4f} ms, call "
          f"{fetch64_times['ms']:.4f} ms, L2 flushed {fetch64_times['flushed_device_ms']:.4f} "
          f"ms, twin {fetch64_times['plain_ms']:.4f} ms, bound {fetch64_bound[0]:.4f} ms by "
          f"{fetch64_bound[1]} (float32 kernel at the same lanes: device "
          f"{fetch_times['device_ms']:.4f} ms)", flush=True)

    print("[33] shell_flight, slant_tau and shell_event float64 builds against their plain "
          "twins", flush=True)
    from eradiate_tpu_torch.kernels import shell_flight as sf

    print("    blocks of 256 threads an SM (registers and shared memory; the float64 flight "
          "kernels with a checkpoint of two float64 sums every ceil(L / "
          f"{sf.CHECKPOINTS_F64}) levels): " + ", ".join(
              f"{k}_f64 {sf.blocks_per_sm(k, 232, torch.float64)} at L = 232, "
              f"{sf.blocks_per_sm(k, 1200, torch.float64)} at L = 1200"
              for k in ("shell_flight", "shell_event", "slant_tau")) + "; shell caps "
          + ", ".join(f"{k}_f64 {sf.shell_cap(k, torch.float64)}"
                      for k in ("shell_flight", "shell_event", "slant_tau")), flush=True)
    layout = sf.layout_differences(4096)
    print("    the wrapper's checkpoint stride and shared-memory sizes, float32 and float64 "
          f"builds, against the library's at 1 to 4096 shells: {len(layout)} differ", flush=True)
    if layout:
        raise AssertionError("the shell wrappers' float64 layout differs from the library's: "
                             f"{layout[:5]}")
    shell64_errs, shell64_times, shell64_bounds = check_shell_kernels_f64(
        "c4 column, mono_double", _shell_inputs_f64(_c4(), B4, seed=10), timed=True)
    # each set built where it is checked, not all up front
    n64 = STRESS_LANES
    sets64 = [
        ("c4 column, mono_double, ragged", lambda: _shell_inputs_f64(_c4(), n64, seed=11)),
        ("unmerged 1200-shell column, mono_double",
         lambda: _shell_inputs_f64(_c4(85.0, None), 2**18, 12)),
    ]
    for column in ("232 shells", "232 shells, vacuum", "1200 shells"):
        for label, w in (("along an axis", shells.AXIS_W), ("toward the SZA 85 sun", sun_85)):
            sets64.append((f"slant stresses, {column}, {label}, in float64",
                           lambda c=column, w=w: _f64(_slant_stress_inputs(c, w, n64, seed=14))))
            sets64.append((f"slant stresses, {column}, {label}, made in float64",
                           lambda c=column, w=w: _slant_stress_inputs(c, w, n64, 17,
                                                                      dtype=np.float64)))
    for column, (radii, sigma) in shells.flight_columns(np.random.default_rng(8)).items():
        sets64.append((f"flight stresses, {column}, in float64",
                       lambda r=radii, s=sigma: _f64(_flight_stress_inputs(
                           r, s, sun_85, n64, 15))))
        sets64.append((f"flight stresses, {column}, made in float64",
                       lambda r=radii, s=sigma: _flight_stress_inputs(r, s, sun_85, n64, 18,
                                                                      dtype=np.float64)))

    def planet():
        p, d, t_max, tau_s, radii, sigma = shells.planet_inputs(
            np.random.default_rng(16), 2**18, device="cuda")
        return p, d, t_max, radii, sigma, tau_s, torch.tensor(sun_85, device="cuda").double()

    sets64.append(("a planet of 1e6 km, 1200 shells of 0.1 km", planet))
    for label, make in sets64:
        errs, _, _ = check_shell_kernels_f64(label, make())
        shell64_errs = {k: max(v, errs[k]) for k, v in shell64_errs.items()}

    double_pixels_gate(34, "c1", _c1, "mono_double", 256, 11)
    pol_c1_double = double_pixels_gate(34, "polarized c1", lambda n: _c1(n, stokes=True),
                                       "mono_polarized_double", 64, 11)
    for sza in (75.0, 85.0):
        double_pixels_gate(34, f"c4 SZA {sza:g}", lambda n, sza=sza: _c4(sza), "mono_double",
                           256, N_VZA_C4)

    runs = {}
    for mode, key in (("mono_double", "collision_fetch_f64"), ("mono_single", "collision_fetch")):
        runs["c1", mode] = profiled_full_width(35, "c1", _c1, mode, SPP_C1_HALF, N_VZA, pp_tracer,
                                               "collision_fetch", key, 100, 48)
    runs["c3", "ckd"] = profiled_full_width(36, "c3, as bench.py names it", _c3, "ckd", SPP_C3,
                                            N_VZA, pp_tracer, "collision_fetch",
                                            "collision_fetch_f64", 100, 48)
    for mode, attr in (("mono_double", "shell_event"), ("mono_single", "shell_flight")):
        key = attr + ("_f64" if mode == "mono_double" else "")
        runs["c4", mode] = profiled_full_width(37, "c4 SZA 75", lambda n: _c4(75.0), mode,
                                               SPP_C4, N_VZA_C4, sph_tracer, attr, key, 16, 32)
    path_b64, path_b64_in_run = path_b_double(37, SPP_C4)
    single = {"c1": runs["c1", "mono_single"], "c4": runs["c4", "mono_single"],
              "c3": {"wall_s": c3_wall, "samples_per_s": N_VZA * SPP_C3 * ROWS_C3 / c3_wall}}
    for cfg, mode in (("c1", "mono_double"), ("c3", "ckd"), ("c4", "mono_double")):
        dbl, sgl = runs[cfg, mode], single[cfg]
        print(f"     {cfg} in {mode} (float64 path state on the card; bench.py's ckd and mono "
              f"are float32 path state on a TPU) against its single mode in this run: wall "
              f"{dbl['wall_s']:.3f} s against {sgl['wall_s']:.3f} s "
              f"({dbl['wall_s'] / sgl['wall_s']:.3f}x), samples/s {dbl['samples_per_s']:.4e} "
              f"against {sgl['samples_per_s']:.4e}"
              + (f", busy {dbl['busy']:.3f} against {sgl['busy']:.3f}, kernels an iteration "
                 f"{dbl['kernels_an_iteration']:.1f} against {sgl['kernels_an_iteration']:.1f}, "
                 f"peak {dbl['peak_gib']:.2f} against {sgl['peak_gib']:.2f} GiB"
                 if "busy" in sgl else " (phase 27 prints its busy share, kernels and peak)"),
              flush=True)
    etp.set_mode("mono_single")
    fetch64_times.update(run_device_ms=runs["c1", "mono_double"]["run_device_ms"],
                         c3_launches=runs["c3", "ckd"]["launches"],
                         c3_run_device_ms=runs["c3", "ckd"]["run_device_ms"])
    shell64_times["shell_event"]["run_device_ms"] = runs["c4", "mono_double"]["run_device_ms"]
    for k in ("shell_flight", "slant_tau"):
        shell64_times[k]["run_ms"] = path_b64_in_run[k][1]
    return {"runs": runs, "path_b": path_b64, "pol_c1": pol_c1_double,
            "fetch": (err64, fetch64_times, fetch64_bound),
            "shells": (shell64_errs, shell64_times, shell64_bounds)}


# ---- the surfaces of the reference's _EVAL (phases A-D) ------------------------


def _beside(phase, label, run, base, base_label):
    """A full-width run's wall, samples/s, ms, CUDA kernels and device ms an
    iteration and busy share beside ``base``'s from this run."""
    def ms(r):
        return 1e3 * r["wall_s"] / r["iterations"]

    print(f"[{phase}] {label} against {base_label} in this run: wall {run['wall_s']:.3f} s "
          f"against {base['wall_s']:.3f} s ({run['wall_s'] / base['wall_s']:.3f}x), samples/s "
          f"{run['samples_per_s']:.4e} against {base['samples_per_s']:.4e}, iterations "
          f"{run['iterations']} against {base['iterations']}, ms an iteration {ms(run):.3f} "
          f"against {ms(base):.3f}, CUDA kernels an iteration {run['kernels_an_iteration']:.1f} "
          f"against {base['kernels_an_iteration']:.1f}, device ms an iteration "
          f"{run['device_ms_an_iteration']:.3f} against {base['device_ms_an_iteration']:.3f}, "
          f"busy {run['busy']:.3f} against {base['busy']:.3f}", flush=True)


def surface_phases(cpu, c1_single, c2_single):
    """Phases A-D, the surface kinds of the reference's ``_EVAL`` and its
    composites: A and B at full width (c1's column over ``rtls``, c2's
    atmosphere over ``ocean_legacy``) beside c1's and c2's runs of this
    script (``c1_single``: phase 35's ``mono_single`` run; ``c2_single``:
    phase 26's), C the kinds and composites on c1's column on CUDA against
    the CPU, D the aerosol in c4 and the textured grounds and the polarized
    aerosol under the c5 canopy against the CPU (``cpu``:
    :class:`CpuRenders`). Returns each kernel's launches on these paths
    and K1's device ms a launch inside A and B."""
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer as pp_tracer

    t0 = time.perf_counter()
    runs = {
        "c1_rtls": profiled_full_width(
            "A", "c1's column over rtls (f_iso 0.209, f_vol 0.081, f_geo 0.004)",
            lambda n: _c1(n, surface={"type": "rtls"}), "mono_single", SPP_C1, N_VZA,
            pp_tracer, "collision_fetch", "collision_fetch", 100, 48),
    }
    _beside("A", "c1 over rtls", runs["c1_rtls"], c1_single,
            "c1 over its Lambertian floor (phase 35, mono_single)")
    runs["c2_ocean_legacy"] = profiled_full_width(
        "B", "c2's atmosphere over ocean_legacy (wind 5 m/s)",
        lambda n: _c2_over(n, {"type": "ocean_legacy", "wind_speed": 5.0}), "mono_single",
        SPP_C2_HALF, N_VZA, pp_tracer, "collision_fetch", "collision_fetch", 64, 48)
    _beside("B", "c2's atmosphere over ocean_legacy", runs["c2_ocean_legacy"], c2_single,
            "c2 over its RPV floor (phase 26)")
    t_ab = time.perf_counter() - t0

    small = {}
    etp.set_mode("mono_single")
    for name, surface in SURFACE_CASES.items():
        small[f"c1_{name}"] = rows_cuda_vs_cpu(
            "C", f"c1 over {name}", lambda n, s=surface: _c1(n, surface=s, target=SURFACE_TARGET),
            1)
    for name in ("rtls", "bitmap"):
        surface = SURFACE_CASES[name]
        small[f"c1_{name}_mono_double"] = double_pixels_gate(
            "C", f"c1 over {name}", lambda n, s=surface: _c1(n, surface=s, target=SURFACE_TARGET),
            "mono_double", 256, 11)
        etp.set_mode(POLARIZED_MODE)
        small[f"c1_{name}_polarized"] = polarized_c1_cuda_vs_cpu(
            "C", f"polarized c1 over {name}",
            lambda n, s=surface: _c1(n, stokes=True, surface=s, target=SURFACE_TARGET))
    etp.set_mode("mono_single")
    t_c = time.perf_counter() - t0 - t_ab

    small["c4_aerosol_sza75"] = c4_cuda_vs_cpu(75.0, "D", "c4 under c2's aerosol", C2_ATMOSPHERE)
    for variant in C5_GROUNDS:
        small[f"c5_{variant}"] = c5_cuda_vs_cpu("instanced", "D", cpu, variant=variant)
    etp.set_mode(POLARIZED_MODE)
    small["c5_polarized_aerosol"] = c5_cuda_vs_cpu("instanced", "D", cpu, stokes=True,
                                                   variant="aerosol")
    etp.set_mode("mono_single")
    t_d = time.perf_counter() - t0 - t_ab - t_c

    launches = {k: {} for k in KERNELS}
    for label, run in runs.items():
        launches["collision_fetch"][label] = run["launches"]
    for label, counts in small.items():
        for k, n in counts.items():
            if n:
                launches[k][f"{label}_small"] = n
    needs = {"c4_aerosol_sza75": ("shell_flight",),
             **{f"c5_{v}": ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced")
                for v in (*C5_GROUNDS, "polarized_aerosol")}}
    for label, counts in small.items():
        keys = needs.get(label, ("collision_fetch_f64",) if label.endswith("double")
                         else ("collision_fetch",))
        if not all(counts[k] > 0 for k in keys):
            raise AssertionError(f"phase C/D's {label} did not launch {keys}")
    print(f"[D] phases A-D took {t_ab + t_c + t_d:.1f} s: A and B {t_ab:.1f} s, C "
          f"{t_c:.1f} s, D {t_d:.1f} s", flush=True)
    return {"launches": launches,
            "run_device_ms": {label: run["run_device_ms"] for label, run in runs.items()}}


def _lit_gate(gpu, cpu):
    """(max rel, median rel, max |z|) of the radiance of two runs over the
    pixels the CPU run lit, |z| against the two runs' variances, Q, U and V
    (with Stokes output) joining the |z|; None where a pixel is dark in one
    run and not in the other, or the CUDA run is not finite."""
    rad_g, rad_c = gpu["radiance"], cpu["radiance"]
    lit = rad_c != 0
    if not (np.isfinite(rad_g).all() and np.array_equal(lit, rad_g != 0) and lit.any()):
        return None
    rel = np.abs(rad_g - rad_c)[lit] / np.abs(rad_c[lit])
    var = (gpu["var"] + cpu["var"])[lit]
    z = max(_max_z(gpu[c][lit], cpu[c][lit], var)
            for c in (("radiance", "Q", "U", "V") if "Q" in cpu else ("radiance",)))
    return float(rel.max()), float(np.median(rel)), z


def case_cuda_vs_cpu(phase, label, case, size, cpu, mode="mono_single"):
    """A scene of phases E-G (:func:`_sensor_case`) at :data:`GATE_SPP` on
    CUDA against its CPU run from ``cpu`` (:class:`CpuRenders`): every lit
    pixel's radiance (and radiosity, where the measure has it) within 1e-4
    relative and |z| <= 5, dark pixels dark in both. Returns the CUDA run's
    launches."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(_sensor_case(case, size), spp=GATE_SPP, seed_state=etp.SeedState(SEED),
                 device="cuda")
    seconds = time.perf_counter() - t0
    launches = read_launches()
    gpu = {k: np.asarray(ds[k]) for k in ds.data_vars}
    cpu_vars, cpu_s = cpu.get(_cpu_case_render, mode, case, size)
    got = _lit_gate(gpu, cpu_vars)
    r = 0.0
    if "radiosity" in cpu_vars:
        r = float(np.max(np.abs(gpu["radiosity"] / cpu_vars["radiosity"] - 1.0)))
    print(f"[{phase}] {label} ({case}, {size}, {GATE_SPP} spp), CUDA vs CPU: "
          + (f"max rel {got[0]:.3e}, median {got[1]:.3e} (bound 1e-4), max |z| {got[2]:.3e} "
             f"(bound 5)" if got else "a pixel dark in one run only")
          + (f", radiosity rel {r:.3e}" if "radiosity" in cpu_vars else "")
          + f"; CUDA run {seconds:.1f} s, CPU run {cpu_s:.1f} s; variables {sorted(gpu)}; "
          f"launches {', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
    if (got is None or got[0] > 1e-4 or got[2] > 5.0 or r > 1e-4
            or set(gpu) != set(cpu_vars)):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on {label}")
    return launches


def timed_full_width(phase, label, exp, spp, n_pix, mode="mono_single"):
    """One timed run of a plane-parallel scene at ``spp`` on ``n_pix``
    pixels (raw pixels: a filtered camera's sub-pixel rays): K1's launches
    must equal the bounce iterations and no other kernel launch. Prints the
    wall, samples/s, iterations, ms an iteration and the worst pixel's
    relative standard error (the dataset's ``var``: the iid estimate of
    the variance of the mean). Returns a dict of them and the dataset."""
    import torch

    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    raw = exp.measures[0].results["raw"]
    iterations, traced = raw["iterations"], raw["spp"]
    rad, var = np.asarray(ds["radiance"]), np.asarray(ds["var"])
    rse = float(np.max(np.sqrt(var) / np.abs(rad)))
    samples = n_pix * traced
    print(f"[{phase}] {label} full width: {n_pix} pixels x {traced} spp = {samples} samples, "
          f"wall {wall:.3f} s, {samples / wall:.4e} samples/s, {iterations} iterations "
          f"({1e3 * wall / iterations:.3f} ms each); worst pixel's relative standard error "
          f"{rse:.4e}; radiance mean {rad.mean():.6e}; launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
    if not (launches["collision_fetch"] > 0 and launches["collision_fetch"] == iterations):
        raise AssertionError(f"{label} did not run through K1 once per bounce")
    if any(n for k, n in launches.items() if k != "collision_fetch"):
        raise AssertionError(f"{label} launched a kernel of another path")
    if not np.isfinite(rad).all() or raw["radiance"].shape[-1] != n_pix:
        raise AssertionError(f"{label}: radiance not finite or of the wrong shape")
    return {"wall_s": wall, "samples_per_s": samples / wall, "iterations": iterations,
            "launches": launches["collision_fetch"], "worst_rse": rse, "spp": traced}, ds


def spot_c5_runs(phase, cpu):
    """Phase H: the c5 scene as ``bench.py`` builds it (instanced HET01)
    under :func:`_spot`, seen by the 128 x 128 box camera :data:`H_CAMERA`:
    a warm-up and a timed run at :data:`H_SPP` in ``mono_single`` (K7's
    nearest and any-hit launches equal to the iterations, no other kernel;
    the operands of both sweeps' ``CAPTURE_AT``-th launch kept), then K7
    nearest and any hit against their plain versions on those rays, the
    shadow rays (each ending at the spot) timed with their bound; the same
    with Stokes output in ``mono_polarized_single`` at
    :data:`H_SPP_POLARIZED`; and both against their CPU runs (8 x 8, 64
    spp) by the canopy gate. Returns (launches by run, the any-hit sweep's
    times and bound on the shadow rays, its max error)."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import canopy as canopy_ops
    from eradiate_tpu_torch.ops import tracer_canopy
    from eradiate_tpu_torch.ops.canopy import InstancedLeafArrays, LeafCloudArrays

    out = {}
    captured = {}
    names = ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced")
    saved = {n: getattr(canopy_ops, n) for n in names}
    saved["leaf_occluded"] = tracer_canopy.leaf_occluded

    def capture(name):
        calls = [0]

        def call(*args):
            calls[0] += 1
            if calls[0] == CAPTURE_AT:
                captured[name] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            return saved[name](*args)
        return call

    def set_all(fns):
        setattr(tracer_canopy, "leaf_occluded", fns["leaf_occluded"])
        for n in names:
            setattr(canopy_ops, n, fns[n])

    for stokes, mode, spp in ((False, "mono_single", H_SPP),
                              (True, POLARIZED_MODE, H_SPP_POLARIZED)):
        etp.set_mode(mode)
        exp = _c5("instanced", stokes=stokes, variant="spot")
        etp.run(exp, spp=4, seed_state=etp.SeedState(0), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        if not stokes:
            set_all({n: capture(n) for n in saved})
        try:
            t0 = time.perf_counter()
            ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            set_all(saved)
        launches = read_launches()
        iterations = exp.measures[0].results["raw"]["iterations"]
        rad = np.asarray(ds["radiance"])
        samples = rad.shape[-1] * spp
        label = f"{'polarized ' if stokes else ''}c5 scene under the spot ({mode})"
        print(f"[{phase}] {label}, 128 x 128 box camera: {samples} samples, wall {wall:.3f} s, "
              f"{samples / wall:.4e} samples/s, {iterations} iterations "
              f"({1e3 * wall / iterations:.3f} ms each), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; lit pixels "
              f"{float((rad > 0).mean()):.3f}, radiance mean {rad.mean():.6e}; launches "
              f"{', '.join(f'{k} {n}' for k, n in launches.items() if n)}", flush=True)
        mine = C5_KERNELS["instanced"]
        if not all(launches[k] > 0 and launches[k] == iterations for k in mine):
            raise AssertionError(f"{label} did not launch {mine} once per bounce")
        if any(n for k, n in launches.items() if k not in mine):
            raise AssertionError(f"{label} launched a kernel of another path")
        if not (np.isfinite(rad).all() and (rad > 0).mean() > 0.2):
            raise AssertionError(f"{label}: radiance not finite or mostly dark")
        out["c5_spot_polarized" if stokes else "c5_spot"] = launches

    # K7 on the run's own rays: the camera and path rays of the nearest
    # sweep, the shadow rays (ending at the spot) of the any-hit sweep
    near, occ = captured[names[0]], captured[names[1]]
    leaves = InstancedLeafArrays(canonical=LeafCloudArrays(*occ[3:6]), offsets=occ[6])
    errs, _, _, _ = check_sweep_kernels(
        f"[{phase}] K7 on the spot run's path rays (launch {CAPTURE_AT})", leaves, near[7],
        tuple(near[:3]), seed=70, plain_lanes=H_PLAIN_LANES)
    errs_s, times, bounds, _ = check_sweep_kernels(
        f"[{phase}] K7 on the spot run's shadow rays (launch {CAPTURE_AT}, each ending at the "
        "spot)", leaves, occ[7], tuple(occ[:3]), seed=71, timed=True, plain_lanes=H_PLAIN_LANES)
    # the shadow rays' lengths, before and after the box advance: the spot
    # stands above the canopy's box, so the box's exit caps most of them;
    # the same vertices toward a point inside a crown (its instance's centre,
    # 10 m up) are cut by their t_max inside the box
    pos, w, t_max = captured["leaf_occluded"][:3]
    _, lo, hi = captured["leaf_occluded"][4]
    far = torch.full_like(t_max, 1e6)
    _, _, cap = canopy_ops._advance_to_aabb(pos, w, t_max, lo, hi)
    _, _, cap_far = canopy_ops._advance_to_aabb(pos, w, far, lo, hi)
    crown = occ[6][0] + torch.tensor([0.0, 0.0, 0.010], dtype=pos.dtype, device=pos.device)
    v = crown - pos
    r = torch.linalg.vector_norm(v, dim=-1)
    d_in = (v / r[:, None]).contiguous()
    p_in, _, cap_in = canopy_ops._advance_to_aabb(pos, d_in, r, lo, hi)
    _, _, cap_in_far = canopy_ops._advance_to_aabb(pos, d_in, far, lo, hi)
    print(f"    the any-hit launch's shadow rays: t_max {float(t_max.min()):.4e} to "
          f"{float(t_max.max()):.4e} km (the sun's 1e6), cut inside the box on "
          f"{float((cap < cap_far).double().mean()):.4f} of the lanes; toward the crown "
          f"centre on {float((cap_in < cap_in_far).double().mean()):.4f}", flush=True)
    errs_in, _, _, _ = check_sweep_kernels(
        f"[{phase}] K7 on the spot run's vertices toward a crown centre (t_max cut in the box)",
        leaves, occ[7], (p_in.contiguous(), d_in, cap_in.contiguous()), seed=72,
        plain_lanes=H_PLAIN_LANES)
    err = max(*errs.values(), *errs_s.values(), *errs_in.values())

    for stokes, mode in ((False, "mono_single"), (True, POLARIZED_MODE)):
        etp.set_mode(mode)
        out[f"c5_spot{'_polarized' if stokes else ''}_{GATE_SPP}spp"] = c5_cuda_vs_cpu(
            "instanced", phase, cpu, stokes=stokes, variant="spot_gate")
    etp.set_mode("mono_single")
    return out, times["ray_leaves_occluded_instanced"], bounds["ray_leaves_occluded_instanced"], err


def submit_sensor_gates(cpu):
    """Queue the CPU sides of phases E-H on ``cpu`` (:class:`CpuRenders`):
    E-G's plane-parallel scenes (a second each), then H's canopy under the
    spot (minutes each)."""
    for case, size in (("perspective", GATE_FILM), ("distant_flux", GATE_FILM),
                       ("mpdistant", GATE_FILM), ("constant", GATE_VZA),
                       ("stratified", GATE_VZA), ("ldsampler", GATE_VZA)):
        cpu.submit(_cpu_case_render, "mono_single", case, size)
    for mode, stokes in (("mono_single", False), (POLARIZED_MODE, True)):
        cpu.submit(_cpu_c5_render, mode, "instanced", WOOD_BRANCHES, stokes, "spot_gate")


def sensor_phases(cpu):
    """Phases E-H, the sensors, emitters and samplers of the reference's
    experiments: E c1's column seen by a perspective camera (Gaussian
    filter, 128 x 128 oversampled twice) at full width, profiled; F three
    runs on c1's column (``distant_flux`` 32 x 32 with its radiosity,
    ``mpdistant`` 64 x 64 over a 10 km rectangle on the reference test's
    ``selectbsdf`` floor, the constant sky at c1's width); G c1 with the
    ``stratified`` and ``ldsampler`` samplers (the one-shot loop's chunks)
    beside the ``independent`` one at :data:`G_SPP`, K1 a launch inside the
    stratified run; H the c5 scene under a spot (:func:`spot_c5_runs`).
    Each against its CPU run from ``cpu`` (:class:`CpuRenders`). Returns
    each kernel's launches on these paths and the phases' extra numbers."""
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer as pp_tracer

    t0 = time.perf_counter()
    runs, small = {}, {}
    runs["perspective"] = profiled_full_width(
        "E", f"c1's column seen by a {E_FILM} x {E_FILM} perspective camera (Gaussian filter, "
        "oversampled twice)", lambda n: _sensor_case("perspective", E_FILM), "mono_single",
        E_SPP, (2 * E_FILM) ** 2, pp_tracer, "collision_fetch", "collision_fetch", 4, 16)
    small["perspective"] = case_cuda_vs_cpu("E", "c1's column, camera", "perspective",
                                            GATE_FILM, cpu)
    t_e = time.perf_counter() - t0

    f_runs = {}
    for case, film, spp, n_pix in (("distant_flux", F_FLUX_FILM, F_FLUX_SPP, F_FLUX_FILM ** 2),
                                   ("mpdistant", F_MPD_FILM, F_MPD_SPP, F_MPD_FILM ** 2),
                                   ("constant", N_VZA, F_SKY_SPP, N_VZA)):
        f_runs[case], ds = timed_full_width("F", f"c1's column, {case}",
                                            _sensor_case(case, film), spp, n_pix)
        if case == "distant_flux":
            print(f"    radiosity {float(np.asarray(ds['radiosity']).ravel()[0]):.6e}, albedo "
                  f"{float(np.asarray(ds['albedo']).ravel()[0]):.6f}", flush=True)
        small[case] = case_cuda_vs_cpu(
            "F", "c1's column", case, GATE_VZA if case == "constant" else GATE_FILM, cpu)
    t_f = time.perf_counter() - t0 - t_e

    g_runs = {}
    for case in SAMPLER_CASES:
        g_runs[case], _ = timed_full_width("G", f"c1, {case} sampler", _sensor_case(case, N_VZA),
                                           G_SPP, N_VZA)
    for case in SAMPLER_CASES[1:]:
        r, base = g_runs[case], g_runs["independent"]
        print(f"[G] {case} against independent in this run: samples/s "
              f"{r['samples_per_s']:.4e} against {base['samples_per_s']:.4e} "
              f"({r['samples_per_s'] / base['samples_per_s']:.3f}x), worst pixel's relative "
              f"standard error {r['worst_rse']:.4e} against {base['worst_rse']:.4e}, traced "
              f"spp {r['spp']} against {base['spp']}", flush=True)
        small[case] = case_cuda_vs_cpu("G", "c1", case, GATE_VZA, cpu)
    n_rec, g_k1_ms = fetch_device_ms_in_run(
        lambda: etp.run(_sensor_case("stratified", N_VZA), spp=G_SPP,
                        seed_state=etp.SeedState(SEED), device="cuda"), skip=8, window=48)
    print(f"[G] collision_fetch {g_k1_ms:.4f} ms of device time a launch inside the stratified "
          f"run ({n_rec} profiler records, {2**21 // N_VZA * N_VZA} lanes a chunk)", flush=True)
    t_g = time.perf_counter() - t0 - t_e - t_f

    spot, shadow_times, shadow_bound, shadow_err = spot_c5_runs("H", cpu)
    t_h = time.perf_counter() - t0 - t_e - t_f - t_g

    launches = {k: {} for k in KERNELS}
    launches["collision_fetch"]["perspective"] = runs["perspective"]["launches"]
    for case, r in {**f_runs, **{f"sampler_{k}": v for k, v in g_runs.items()}}.items():
        launches["collision_fetch"][case] = r["launches"]
    for label, counts in {**{f"{k}_{GATE_SPP}spp": v for k, v in small.items()},
                          **spot}.items():
        for k, n in counts.items():
            if n:
                launches[k][label] = n
    print(f"[H] phases E-H took {t_e + t_f + t_g + t_h:.1f} s: E {t_e:.1f} s, F {t_f:.1f} s, "
          f"G {t_g:.1f} s, H {t_h:.1f} s", flush=True)
    return {"launches": launches,
            "collision_fetch": {"perspective_run_device_ms": runs["perspective"]["run_device_ms"],
                                "one_shot_run_device_ms": g_k1_ms},
            "ray_leaves_occluded_instanced": {
                "spot_shadow_rays": {**shadow_times, "bound_ms": shadow_bound[0],
                                     "bound_by": shadow_bound[1], "max_abs_err": shadow_err}}}


# ---- DEM terrain (phases I-K) -------------------------------------------------

#: Phase I's tile: 15 km x 15 km at 30 m posts (501 x 501), the size of a
#: Copernicus GLO-30 / SRTM tile crop.
DEM_TILE = {"height_km": 1.0, "sigma_km": 2.0, "extent_km": 15.0, "n": 501}
#: Phase K's hill, the CPU tests' shape.
DEM_HILL = {"height_km": 1.0, "sigma_km": 1.0, "extent_km": 10.0, "n": 33}
N_VZA_DEM = 19
#: Samples a pixel of phase I's tile: half of c5's (a cut beside phases P-Q).
SPP_DEM = 1048576
#: Iterations before, and in, the profiler window of phase I's warm-up runs.
DEM_SKIP, DEM_WINDOW = 8, 16
#: Lanes of phase J's sample of the captured rays.
DEM_PLAIN_LANES = 2**14
#: The same for the float64 builds (2^14 before: the float64 plain sweep
#: tests a pair ~9x slower, 26 and 15 s of the script).
DEM_PLAIN_LANES_F64 = 2**12
#: Box growth (km) of phase J's chunk cull: far above float32's rounding of
#: a hit point 20 km from the ray's origin.
DEM_CULL_SLACK = 0.1
#: Chunks of the soup a call of the plain version takes in phase J.
DEM_CULL_RUN = 16
#: The modes of phase K's gates and their relative bounds.
DEM_GATE_MODES = (("mono_single", 1e-4), ("mono_double", 1e-10), ("ckd_single", 1e-4),
                  ("mono_polarized_single", 1e-4))
#: G-points of the CKD gate's bin (4 spectral rows; the default 16 took 47 s
#: through the marcher on the card's host).
DEM_GATE_NG = 4


def _dem(full, triangulate, ng_max=None):
    """Phase I's terrain (``full``) or phase K's hill as a
    ``DEMExperiment`` on c1's column; ``ng_max`` caps the g-points of a
    CKD bin."""
    from eradiate_tpu_torch.experiments import DEMExperiment
    from eradiate_tpu_torch.scenes.surface import DEMSurface

    surface = DEMSurface.gaussian_hill(**(DEM_TILE if full else DEM_HILL),
                                       bsdf={"type": "lambertian", "reflectance": 0.5})
    surface.triangulate = triangulate
    half = 2.0
    return DEMExperiment(
        illumination={"type": "directional", "zenith": 30.0 if full else 60.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "azimuth": 0.0, "id": "m",
                  "zeniths": np.linspace(-75, 75, N_VZA_DEM) if full else [-45.0, 0.0, 45.0],
                  "target": {"type": "rectangle", "xmin": -half, "xmax": half,
                             "ymin": -half, "ymax": half, "z": 1.1}},
        surface=surface,
        atmosphere={"type": "molecular"},
        geometry={"type": "plane_parallel", "layer_merge_tol": 1e-3},
        **({} if ng_max is None else {"ckd_quad_config": {"ng_max": ng_max}}),
    )


def _dem_gate_render(mode, triangulate, device):
    """Phase K's hill at :data:`GATE_SPP` and the gates' seed on
    ``device``: (radiance, variance, brf, data variables' names), seconds."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    exp = _dem(False, triangulate, DEM_GATE_NG if mode.startswith("ckd") else None)
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=GATE_SPP, seed_state=etp.SeedState(SEED), device=device)
    seconds = time.perf_counter() - t0
    raw = exp.measures[0].results["raw"]
    rad, m2 = (np.asarray(raw[k], np.float64) for k in ("radiance", "m2"))
    return {"radiance": rad, "var": np.maximum(m2 - rad * rad, 0.0) / raw["spp"],
            "brf": np.asarray(ds["brf"]), "variables": sorted(ds.data_vars)}, seconds


def _cpu_dem_render(mode, triangulate):
    """:func:`_dem_gate_render` on the CPU (a :class:`CpuRenders` job)."""
    return _dem_gate_render(mode, triangulate, "cpu")


def submit_dem_gates(cpu):
    """Queue phase K's CPU sides on ``cpu``."""
    for mode, _ in DEM_GATE_MODES:
        for triangulate in (False, True):
            cpu.submit(_cpu_dem_render, mode, triangulate)


def _dem_run(triangulate, window):
    """A full-width run of phase I's terrain in ``mono_single``; with
    ``window`` it is the profiled warm-up: the profiler records
    :data:`DEM_WINDOW` iterations after :data:`DEM_SKIP` and the run ends
    there, and the operands of K8's :data:`CAPTURE_AT`-th nearest and
    any-hit launches are kept. Returns (profiler or dataset, the
    experiment, the hierarchy's build seconds, the captured ``p``, ``d``,
    ``t_cap`` by wrapper, the soup and the hierarchy the render built)."""
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import mesh, tracer_dem

    etp.set_mode("mono_single")
    exp = _dem(True, triangulate)
    build, built = [], []
    captured = {}
    saved = {"tri_accel": tracer_dem.tri_accel, "ray_tris_nearest": mesh.ray_tris_nearest,
             "ray_tris_occluded": mesh.ray_tris_occluded}

    def timed_accel(tris):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved["tri_accel"](tris)
        torch.cuda.synchronize()
        build.append(time.perf_counter() - t0)
        built[:] = [tris, out]
        return out

    def capturing(name):
        calls = [0]

        def call(*args):
            calls[0] += 1
            if calls[0] == CAPTURE_AT:
                captured[name] = [a.clone() for a in args[:3]]
            return saved[name](*args)
        return call

    def run():
        return etp.run(exp, spp=SPP_DEM, seed_state=etp.SeedState(SEED), device="cuda")

    tracer_dem.tri_accel = timed_accel
    if window:
        mesh.ray_tris_nearest = capturing("ray_tris_nearest")
        mesh.ray_tris_occluded = capturing("ray_tris_occluded")
    try:
        if window:
            out = profile_window(run, tracer_dem, "bounce_uniforms", DEM_SKIP, DEM_WINDOW)
        else:
            out = run()
    finally:
        tracer_dem.tri_accel = saved["tri_accel"]
        mesh.ray_tris_nearest = saved["ray_tris_nearest"]
        mesh.ray_tris_occluded = saved["ray_tris_occluded"]
    return out, exp, sum(build), captured, built


def dem_full_width(phase, triangulate):
    """Phase I for one intersector: the profiled warm-up, then the timed
    run. Returns a dict of the numbers printed, the captured K8 operands
    (triangulated) and the soup."""
    import torch

    label = "triangulated (K8)" if triangulate else "marched"
    prof, _, build_warm, captured, _ = _dem_run(triangulate, window=True)
    per_it, dev_ms, shares = window_device(prof, DEM_WINDOW)
    k8 = {}
    if triangulate:
        for k in ("ray_tris_nearest", "ray_tris_occluded"):
            k8[k] = kernel_ms_in_window(prof, KERNELS[k], DEM_WINDOW // 2)[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds, exp, build, _, built = _dem_run(triangulate, window=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    iterations = exp.measures[0].results["raw"]["iterations"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    brf = np.asarray(ds["brf"])
    samples = N_VZA_DEM * SPP_DEM
    busy = dev_ms * iterations / (1e3 * wall)
    n_tris = built[0].v0.shape[0] if triangulate else 0
    print(f"[{phase}] DEM {label}, {DEM_TILE['n']} x {DEM_TILE['n']} posts"
          + (f", {n_tris} triangles" if triangulate else "")
          + f" (mono_single) full width: {N_VZA_DEM} VZA x {SPP_DEM} spp = {samples} samples, "
          f"wall {wall:.3f} s" + (f" (of which the hierarchy's build {build:.3f} s; warm-up "
                                  f"build {build_warm:.3f} s)" if triangulate else "")
          + f", {samples / wall:.4e} samples/s, {iterations} iterations "
          f"({1e3 * wall / iterations:.3f} ms each), peak device memory {peak:.2f} GiB",
          flush=True)
    print(f"    profiler window of {DEM_WINDOW} iterations after {DEM_SKIP} (warm-up run): "
          f"{per_it:.1f} CUDA kernels and {dev_ms:.3f} ms of device time an iteration, busy "
          f"share {busy:.3f}; by kernel family: "
          f"{', '.join(f'{f} {x:.3f}' for f, x in shares.items())}"
          + "".join(f"; {k} {ms:.4f} ms a launch inside the run" for k, ms in k8.items())
          + f"; launches {', '.join(f'{k} {n}' for k, n in launches.items() if n) or 'none'}; "
          f"BRF {brf.dtype}, shape {brf.shape}, mean {brf.mean():.6f}, at nadir "
          f"{float(brf[0, N_VZA_DEM // 2]):.6f}", flush=True)
    if triangulate:
        if not (launches["ray_tris_nearest"] == iterations > 0
                and launches["ray_tris_occluded"] == 2 * iterations):
            raise AssertionError("the triangulated DEM did not launch K8 nearest once and any "
                                 "hit twice an iteration")
        others = {k for k, n in launches.items() if n} - {"ray_tris_nearest",
                                                         "ray_tris_occluded"}
        if n_tris != 500_000 or set(captured) != {"ray_tris_nearest", "ray_tris_occluded"}:
            raise AssertionError("the triangulated DEM is not the 500,000-triangle soup, or "
                                 "no K8 launch was captured")
    else:
        others = {k for k, n in launches.items() if n}
    if others:
        raise AssertionError(f"the DEM {label} launched kernels of other paths: {others}")
    if brf.shape != (1, N_VZA_DEM) or not np.isfinite(brf).all() or not (
            0.2 < brf.mean() < 0.8):
        raise AssertionError(f"the DEM {label} BRF is not finite or out of range")
    out = {"wall_s": wall, "samples_per_s": samples / wall, "iterations": iterations,
           "kernels_an_iteration": per_it, "device_ms_an_iteration": dev_ms, "busy": busy,
           "peak_gib": peak, "brf_mean": float(brf.mean()), "launches": launches}
    if triangulate:
        out.update(build_s=build, run_device_ms=k8, triangles=n_tris)
    return out, captured, built


def _chunk_culled_plain(plain, args, occluded, slack=DEM_CULL_SLACK):
    """The plain K8 sweep ``plain`` on rays ``args[:3]`` (``p``, ``d``,
    ``t_cap``) against the soup ``args[3:6]``, run on runs of
    :data:`DEM_CULL_RUN` chunks of
    :data:`~eradiate_tpu_torch.kernels.tri_intersect.CHUNK` triangles in
    their order, each on the rays whose clipped segment's box (grown by
    ``slack``) reaches the run's box, and merged as the dense sweep merges
    its chunks (a strictly nearer chunk replaces the best; any hit ors). A
    run holds no triangle the exact test accepts for a ray whose segment's
    box misses its box, and it holds whole chunks in their order, so the
    result is the dense sweep's bit for bit, at a fraction of its pairs.
    Returns the plain version's outputs and the pairs it tested."""
    import torch

    from eradiate_tpu_torch.kernels.tri_intersect import CHUNK

    p, d, t = args[:3]
    v0, e1, e2 = args[3:6]
    B, N = p.shape[0], v0.shape[0]
    end = p + d * t[:, None]
    s_lo, s_hi = torch.minimum(p, end) - slack, torch.maximum(p, end) + slack
    verts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)  # [N, 3, 3]
    pad = (-N) % CHUNK
    lo = verts.min(dim=1).values
    hi = verts.max(dim=1).values
    if pad:
        lo = torch.cat([lo, lo[-1:].expand(pad, 3)])
        hi = torch.cat([hi, hi[-1:].expand(pad, 3)])
    c_lo = lo.reshape(-1, CHUNK, 3).min(dim=1).values
    c_hi = hi.reshape(-1, CHUNK, 3).max(dim=1).values
    # runs of DEM_CULL_RUN chunks: fewer, larger calls; a run holds whole
    # chunks in their order, so the plain version's own chunks are the soup's
    pad = (-c_lo.shape[0]) % DEM_CULL_RUN
    c_lo = torch.cat([c_lo, c_lo[-1:].expand(pad, 3)]).reshape(-1, DEM_CULL_RUN, 3)
    c_hi = torch.cat([c_hi, c_hi[-1:].expand(pad, 3)]).reshape(-1, DEM_CULL_RUN, 3)
    c_lo, c_hi = c_lo.min(dim=1).values, c_hi.max(dim=1).values
    run = CHUNK * DEM_CULL_RUN
    best_t = torch.full((B,), torch.inf, dtype=p.dtype, device=p.device)
    best_n = torch.zeros((B, 3), dtype=p.dtype, device=p.device)
    best_n[:, 2] = 1.0
    occ = torch.zeros(B, dtype=torch.bool, device=p.device)
    pairs = 0
    for c in range(c_lo.shape[0]):
        reach = ((s_lo <= c_hi[c]) & (s_hi >= c_lo[c])).all(dim=1)
        lanes = torch.nonzero(reach).squeeze(1)
        if not lanes.numel():
            continue
        sl = slice(c * run, min((c + 1) * run, N))
        pairs += lanes.numel() * (sl.stop - sl.start)
        out = plain(p[lanes], d[lanes], t[lanes], v0[sl], e1[sl], e2[sl])
        if occluded:
            occ[lanes] |= out
            continue
        t_c, n_c, hit_c = out
        tmin = torch.where(hit_c, t_c, torch.inf)
        better = tmin < best_t[lanes]
        best_n[lanes] = torch.where(better[:, None], n_c, best_n[lanes])
        best_t[lanes] = torch.where(better, tmin, best_t[lanes])
    if occluded:
        return (occ,), pairs
    hit = torch.isfinite(best_t)
    return (torch.where(hit, best_t, t), best_n, hit), pairs


def check_terrain_kernels(label, tris, cull, rays, seed, f64, name):
    """Phase J for one wrapper ``name`` (K8 nearest or any hit) and one
    build: the kernel on ``rays`` (the captured ``p``, ``d``, ``t_cap`` of
    its own launches) against the terrain soup ``tris``, every output bit
    pattern for bit pattern with the plain version on a seeded sample of
    :data:`DEM_PLAIN_LANES` lanes (float64: :data:`DEM_PLAIN_LANES_F64`;
    :func:`_chunk_culled_plain`), timed (call
    and device ms, the culled plain's ms) with its bound (:func:`_item_pairs`
    on 512 of the sampled lanes, scaled). Returns (kernel, max abs error,
    times, bound)."""
    import torch

    from eradiate_tpu_torch.kernels import tri_intersect as ti

    suffix, peak = ("_f64", PEAK_F64_FLOPS) if f64 else ("", PEAK_F32_FLOPS)
    kernel, occluded = name + suffix, name == "ray_tris_occluded"
    B = rays[0].shape[0]
    n_plain = DEM_PLAIN_LANES_F64 if f64 else DEM_PLAIN_LANES
    chosen = np.sort(np.random.default_rng(seed).choice(B, n_plain, replace=False))
    subset = torch.tensor(chosen, device=rays[0].device)
    table = (tris.v0, tris.e1, tris.e2)
    fn = getattr(ti, name)

    def call():
        return fn(*rays, *table, cull)

    got = call()
    got = got if isinstance(got, tuple) else (got,)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want, pairs = _chunk_culled_plain(getattr(ti, name + "_plain"),
                                      (*[a[subset].contiguous() for a in rays], *table),
                                      occluded)
    end.record()
    end.synchronize()
    err = 0.0
    for g, w in zip((g[subset] for g in got), want):
        bits = torch.int64 if g.dtype == torch.float64 else torch.int32
        gb, wb = (x.view(bits) if x.is_floating_point() else x for x in (g, w))
        differ = int((gb != wb).reshape(n_plain, -1).any(dim=1).sum())
        if g.dtype != w.dtype or differ:
            raise AssertionError(f"{label}: {kernel} differs from the plain version on "
                                 f"{differ} of {n_plain} lanes")
        err = max(err, float((g.double() - w.double()).abs().max()))
    device, by = _device_ms(call, KERNELS[kernel])
    times = {"ms": _time_ms(call), "device_ms": device, "device_by": by,
             "plain_ms": start.elapsed_time(end), "lanes": B, "plain_lanes": n_plain,
             "plain_pairs": pairs}
    n_bytes = sum(x.numel() * x.element_size() for x in tuple(rays) + table + got)
    cap, occ = (rays[2], got[0]) if occluded else (got[0], None)
    item_pairs = _item_pairs(tris, rays, cap, occ, subset[:512], lanes=32)
    bound = bound_ms(n_bytes, 45.0 * item_pairs, peak)
    print(f"  {label}: B={B} N={tris.v0.shape[0]} every output's bit pattern equal on "
          f"{n_plain} seeded lanes, 0 lanes differ; {kernel} "
          f"{'occluded' if occluded else 'hit'} share {float(got[-1].float().mean()):.3f}, "
          f"culled plain {times['plain_ms']:.1f} ms ({pairs / n_plain:.0f} triangles "
          f"a lane), kernel {times['ms']:.4f} ms (device {device:.4f} by the {by}), "
          f"{item_pairs / B:.2f} exact tests a ray at item granularity, bound "
          f"{bound[0]:.4f} ms by {bound[1]}", flush=True)
    return kernel, err, times, bound


def dem_gate(phase, mode, rtol, triangulate, cpu):
    """Phase K for one mode and intersector: the hill on CUDA against its
    CPU run from ``cpu``: radiance within ``rtol`` relative and |z| <= 5,
    the same data variables. Returns the CUDA run's launches."""
    reset_launches()
    gpu, seconds = _dem_gate_render(mode, triangulate, "cuda")
    launches = read_launches()
    ref, cpu_s = cpu.get(_cpu_dem_render, mode, triangulate)
    rel = float(np.max(np.abs(gpu["radiance"] - ref["radiance"]) / np.abs(ref["radiance"])))
    z = _max_z(gpu["radiance"], ref["radiance"], gpu["var"] + ref["var"])
    label = "triangulated" if triangulate else "marched"
    print(f"[{phase}] DEM hill {label} ({mode}, {GATE_SPP} spp), CUDA vs CPU: max rel "
          f"{rel:.3e} (bound {rtol:g}), max |z| {z:.3e} (bound 5), rows "
          f"{gpu['radiance'].shape[0]}; CUDA run {seconds:.1f} s, CPU run {cpu_s:.1f} s; "
          f"launches {', '.join(f'{k} {n}' for k, n in launches.items() if n) or 'none'}",
          flush=True)
    k8 = "ray_tris_nearest_f64" if mode == "mono_double" else "ray_tris_nearest"
    if triangulate and not launches[k8]:
        raise AssertionError(f"the triangulated DEM in {mode} did not launch {k8}")
    if not (np.isfinite(gpu["radiance"]).all() and rel <= rtol and z <= 5.0
            and gpu["variables"] == ref["variables"]):
        raise AssertionError(f"CUDA and CPU runs of the DEM hill disagree in {mode}")
    if mode == "mono_polarized_single" and "I" in gpu["variables"]:
        raise AssertionError("the DEM rendered Stokes output in a polarized mode")
    return launches


def dem_phases(cpu):
    """Phases I-K. Returns the DEM numbers of K8 and its float64 build for
    the kernels line: launches, times and bounds on the terrain, and the
    device ms a launch inside phase I's run."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops.dem import mesh_from_dem
    from eradiate_tpu_torch.ops.mesh import tri_accel

    t0 = time.perf_counter()
    marched, _, _ = dem_full_width("I", False)
    tri, captured, built = dem_full_width("I", True)
    print(f"    triangulated against marched: samples/s {tri['samples_per_s']:.4e} against "
          f"{marched['samples_per_s']:.4e}, BRF mean {tri['brf_mean']:.6f} against "
          f"{marched['brf_mean']:.6f}", flush=True)

    print("[J] K8 (bvh_nearest_kernel, bvh_occluded_kernel) and its float64 build on the "
          "terrain soup, on the rays of phase I's eighth launches", flush=True)
    tris, (cull, _, _) = built
    s = _dem(True, True).surface
    t1 = time.perf_counter()
    tris64 = mesh_from_dem(s.elevation, s.x0, s.y0, s.dx, s.dy, dtype=np.float64, device="cuda")
    cull64 = tri_accel(tris64)[0]
    print(f"    float64 soup and hierarchy built in {time.perf_counter() - t1:.3f} s", flush=True)
    errs, times, bounds = {}, {}, {}
    # each wrapper on its own rays: nearest on the path rays, any hit on
    # the shadow rays
    for kind, what in (("ray_tris_nearest", "path"), ("ray_tris_occluded", "shadow")):
        rays = tuple(a.contiguous() for a in captured[kind])
        for f64 in (False, True):
            k, errs[k], times[k], bounds[k] = check_terrain_kernels(
                f"terrain, {what} rays" + (" in float64" if f64 else ""),
                tris64 if f64 else tris, cull64 if f64 else cull,
                tuple(a.double() for a in rays) if f64 else rays, seed=80, f64=f64, name=kind)
    del tris, tris64, cull, cull64, built, captured
    torch.cuda.empty_cache()

    launches64 = {}
    for mode, rtol in DEM_GATE_MODES:
        for triangulate in (False, True):
            n = dem_gate("K", mode, rtol, triangulate, cpu)
            if triangulate and mode == "mono_double":
                launches64 = {k: n[k + "_f64"] for k in ("ray_tris_nearest", "ray_tris_occluded")}
    etp.set_mode("mono_single")
    print(f"    phases I-K took {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    for k in ("ray_tris_nearest", "ray_tris_occluded"):
        out[k] = {"launches": tri["launches"][k], "iterations": tri["iterations"],
                  "run_device_ms": tri["run_device_ms"][k], "max_abs_err": errs[k],
                  **times[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "wall_s": tri["wall_s"], "build_s": tri["build_s"]}
        out[k + "_f64"] = {"launches_hill_mono_double": launches64[k],
                           "max_abs_err": errs[k + "_f64"], **times[k + "_f64"],
                           "bound_ms": bounds[k + "_f64"][0], "bound_by": bounds[k + "_f64"][1]}
    out["marched"] = marched
    return out


# -- L-N. forward-mode sensitivities ------------------------------------------

#: Phase M's channels on c1, and the retrieval's (the JAX package's
#: ``tests/system/test_retrieval.py``: truth, start, views, samples, seeds).
SENS_C1_CHANNELS = ("surface.reflectance", "medium.albedo", "medium.tau_scale")
RETRIEVAL_TRUTH, RETRIEVAL_START = (0.32, 1.35), (0.5, 1.0)
RETRIEVAL_ZENITHS = (-60.0, -30.0, 0.0, 30.0, 60.0)
RETRIEVAL_SPP = 16384
#: Phase N's samples a pixel: c1 at 11 views; the spherical, canopy and DEM
#: scenes at 3 views.
SENS_GATE_SPP, SENS_SMALL_SPP = 256, 64
#: Phase N's channels by scene.
SENS_GATE_CHANNELS = {
    "c1": SENS_C1_CHANNELS,
    "spherical": ("surface.reflectance", "medium.albedo", "medium.tau_scale"),
    "canopy": ("canopy.reflectance", "canopy.transmittance", "surface.reflectance"),
    "dem": ("surface.reflectance", "medium.tau_scale"),
}


def _sens_scene(case):
    """Phase N's scenes: ``c1`` at 11 views; ``spherical``, c1's column in
    shells under an SZA 30 sun at views -45, 0, 45; ``canopy``, the 200-leaf
    cloud of the JAX package's canopy sensitivity tests; ``dem``, phase K's
    33 x 33 hill."""
    import eradiate_tpu_torch as etp

    views = {"type": "mdistant", "construct": "hplane", "zeniths": [-45.0, 0.0, 45.0],
             "azimuth": 0.0, "id": "m"}
    sun = {"type": "directional", "zenith": 30.0, "azimuth": 0.0}
    if case == "c1":
        return _c1(11)
    if case == "spherical":
        return etp.AtmosphereExperiment(
            geometry={"type": "spherical_shell"}, illumination=sun, measures=views,
            surface={"type": "lambertian", "reflectance": 0.5}, atmosphere={"type": "molecular"})
    if case == "canopy":
        return etp.CanopyExperiment(
            canopy={"type": "leaf_cloud", "construct": "cuboid", "n_leaves": 200,
                    "leaf_radius": 0.12, "l_horizontal": 10.0, "l_vertical": 2.0,
                    "leaf_reflectance": 0.45, "leaf_transmittance": 0.25, "seed": 5},
            illumination=sun, measures={**views, "zeniths": [-30.0, 0.0, 30.0]},
            surface={"type": "lambertian", "reflectance": 0.3})
    return _dem(False, False)


def _sens_render(case, device):
    """Phase N's sensitivities of ``case`` on ``device``: the measure's entry
    (numpy), and the seconds it took."""
    from eradiate_tpu_torch.sensitivity import sensitivities

    t0 = time.perf_counter()
    spp = SENS_GATE_SPP if case == "c1" else SENS_SMALL_SPP
    (entry,) = sensitivities(_sens_scene(case), SENS_GATE_CHANNELS[case], spp=spp, seed=SEED,
                             device=device).values()
    return entry, time.perf_counter() - t0


def _cpu_sens_render(mode, case):
    """:func:`_sens_render` on the CPU in ``mode`` (:class:`CpuRenders`' job)."""
    import eradiate_tpu_torch as etp

    etp.set_mode(mode)
    return _sens_render(case, "cpu")


def submit_sensitivity_gates(cpu):
    """Queue phase N's CPU sides."""
    for case in SENS_GATE_CHANNELS:
        cpu.submit(_cpu_sens_render, "mono_single", case)


def _dual_refusals():
    """A forward-mode dual into each geometry wrapper (K2, K3, K5-K9, the
    terrain march) and into the operands of K1, K4 and the shell depths that
    have no rule must raise ``NotImplementedError``, launching nothing
    (``test_tools/duals.geometry_calls``); returns the names held."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from eradiate_tpu_torch.test_tools.duals import geometry_calls

    p, calls = geometry_calls("cuda", B=64)
    before = read_launches()
    with fwAD.dual_level():
        dual = fwAD.make_dual(p, torch.ones_like(p))
        for name, call in calls.items():
            try:
                call(dual)
            except NotImplementedError:
                continue
            raise AssertionError(f"{name} took a forward-mode dual without raising")
    if read_launches() != before:
        raise AssertionError("a refused dual launched a kernel")
    return list(calls)


def _rule_case(label, kernel_fn, plain_fn, kernel, f64, n_bytes, flops, times=True,
               per_call=1):
    """One forward rule (or the shell depths) on the card against the same
    function on the plain versions: every output bit for bit; with
    ``times`` its call time, device time (of ``kernel``, the rule's second
    launch included), the plain version's time and the bound. Returns
    (0.0, times)."""
    import torch

    got, want = kernel_fn(), plain_fn()
    for i, (g, w) in enumerate(zip(got, want)):
        differ = (_bits(g) != _bits(w)).reshape(-1)
        if differ.any():
            raise AssertionError(f"{label}: output {i} differs from the plain version on "
                                 f"{int(differ.sum())} of {differ.numel()} lanes")
    lanes = got[0].shape[-1]
    line = f"  {label}: {lanes} lanes, {got[0].dtype}: bit for bit on every lane"
    out = None
    if times:
        device, by = _device_ms(kernel_fn, kernel, per_call=per_call)
        out = {"ms": _time_ms(kernel_fn), "device_ms": device, "device_by": by,
               "plain_ms": _time_ms(plain_fn, reps=5), "lanes": lanes}
        bound = bound_ms(n_bytes, flops, PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
        out.update(bound_ms=bound[0], bound_by=bound[1])
        line += (f"; call {out['ms']:.4f} ms, device {device:.4f} ms (by the {by}), plain "
                 f"{out['plain_ms']:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}")
    print(line, flush=True)
    torch.cuda.synchronize()
    return 0.0, out


def _tangent(x):
    import torch.autograd.forward_ad as fwAD

    return fwAD.unpack_dual(x).tangent


def _depth_levels(p, d, t_max, radii):
    """The levels a lane's depths need: those up to the bracket of the
    larger of |x0| and |x0 + t_max| (the sweep reads every level; the
    bound counts these)."""
    import torch

    from eradiate_tpu_torch.ops.spherical import cross_norm2, dot3, sqrt_rn

    x0 = dot3(p, d)
    X = sqrt_rn(torch.clamp((radii * radii)[:, None] - cross_norm2(p, d), min=0.0))
    y = torch.maximum(x0.abs(), (x0 + t_max).abs())
    return int((X <= y).sum())


def forward_rule_phase(phase, B1, B4, sun_85):
    """Phase L: K1's rule (a tangent on the fetched tables) at c1's lanes
    ``B1`` and K4's (a tangent on sigma) at path B's ``B4``, float32 and
    float64, against the same rules on the plain versions, bit for bit;
    the shell depths (float32 and float64) against their plain version on
    the flight's stress lanes (six columns) and on every lane of path B's
    first events; every geometry wrapper refusing a dual. Returns {name: (err,
    times)} for ``collision_fetch_rule``, ``slant_tau_rule`` (and ``_f64``)
    and ``shell_depths`` (and ``_f64``)."""
    import torch
    import torch.autograd.forward_ad as fwAD

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import collision_fetch as cf
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import TAU_BLOCKED, fma, shell_depths_plain
    from eradiate_tpu_torch.ops.spherical import slant_tau_exact
    from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools
    from eradiate_tpu_torch.test_tools import shells
    from eradiate_tpu_torch.test_tools.collision_fetch import search_trips, stress_queries

    print(f"[{phase}] the forward rules of K1 and K4 and the shell depths against their plain "
          "versions", flush=True)
    out = {}
    rng = np.random.default_rng(70)
    for dt in (np.float32, np.float64):
        f64 = dt == np.float64
        sfx = "_f64" if f64 else ""
        etp.set_mode("mono_double" if f64 else "mono_single")
        column = fetch_tools.column_operands(dtype=dt)
        z_lv, tau_lv, tables = (torch.tensor(a, device="cuda") for a in column)
        q = torch.tensor(stress_queries(column[1], B1, 71), device="cuda")
        # the tables of the likelihood-ratio flight: the layers' thicknesses
        # first; tangents as the tau_scale and albedo channels give them
        tabs = torch.cat([torch.diff(tau_lv)[None], tables]).contiguous()
        tan = torch.cat([torch.diff(tau_lv)[None], torch.ones_like(tables[:1]),
                         torch.zeros_like(tables[1:])]).contiguous()

        def rule():
            with fwAD.dual_level():
                z, layer, f = cf.collision_fetch(q, z_lv, tau_lv, fwAD.make_dual(tabs, tan))
                return (fwAD.unpack_dual(z).primal.clone(), layer, fwAD.unpack_dual(f).primal
                        .clone(), _tangent(f).clone())

        def plain():
            z, layer, f = cf.collision_fetch_plain(q, z_lv, tau_lv, tabs)
            return z, layer, f, cf.collision_fetch_plain(q, z_lv, tau_lv, tan)[2]

        K, L = tabs.shape
        # what the function must move: the queries and both level tables
        # read once, the tables and their tangents read once, z, the layer
        # (int32), the fetched rows and their tangents written once; and one
        # search a lane (the rule's second launch repeats it)
        n_bytes = q.element_size() * (B1 * (2 + 2 * K) + 2 * (L + 1) + 2 * K * L) + 4 * B1
        out["collision_fetch_rule" + sfx] = _rule_case(
            f"K1{' f64' if f64 else ''}'s rule, c1 column (K = {K} with the layers' "
            "thicknesses)", rule, plain, KERNELS["collision_fetch" + sfx], f64, n_bytes,
            B1 * (search_trips(L) + 6), per_call=2)

        exp4 = _c4(75.0)
        p, d, t_max, radii, sigma, tau_s, w = (_shell_inputs_f64 if f64 else _shell_inputs)(
            exp4, B4, seed=72)
        collide, t_col, layer = sf.shell_flight(p, d, t_max, radii, sigma, tau_s)
        t_step = torch.where(collide, t_col, t_max)[:, None]
        pe = fma(d, t_step, p).contiguous()
        sig_t = (sigma * torch.tensor(rng.uniform(0.5, 1.5, sigma.shape[0]),
                                      device="cuda", dtype=sigma.dtype)).contiguous()

        def slant_rule():
            with fwAD.dual_level():
                tau = sf.slant_tau(pe, w, radii, fwAD.make_dual(sigma, sig_t))
                return fwAD.unpack_dual(tau).primal.clone(), _tangent(tau).clone()

        def slant_plain():
            tau = slant_tau_exact(pe, w, radii, sigma)
            return tau, torch.where(tau == TAU_BLOCKED, 0.0, slant_tau_exact(pe, w, radii, sig_t))

        segs = float(shells.crossed_segments(pe, w, radii).sum())
        out["slant_tau_rule" + sfx] = _rule_case(
            f"K4{' f64' if f64 else ''}'s rule, path B's event points", slant_rule, slant_plain,
            KERNELS["slant_tau" + sfx], f64, pe.element_size() * B4 * 5,
            2 * (40.0 * B4 + 15.0 * segs), per_call=2)

        full = (p, d, t_col, layer, t_max, radii, sigma)
        pick = torch.tensor(np.sort(np.random.default_rng(74).choice(B4, 2**16, replace=False)),
                            device="cuda")
        sample = tuple(a[pick].contiguous() for a in full[:5]) + full[5:]
        cases = [("path B's first events, a seeded 2^16-lane sample", sample)]
        for column_name, (r_c, s_c) in shells.flight_columns(np.random.default_rng(8)).items():
            # the flight's stress sets of phases 7 and 33 (made in float64)
            ps, ds, tm, rr, ss, ts, _ = _flight_stress_inputs(
                r_c, s_c, sun_85, STRESS_LANES,
                18 if f64 else 15, dtype=dt)
            _, tc, lay = sf.shell_flight(ps, ds, tm, rr, ss, ts)
            cases.append((f"flight stresses, {column_name}", (ps, ds, tc, lay, tm, rr, ss)))
        for label, args in cases:
            _rule_case(f"shell_depths{' f64' if f64 else ''}, {label}",
                       lambda: sf.shell_depths(*args), lambda: shell_depths_plain(*args), None,
                       f64, 0, 0, times=False)
        # timed at path B's lanes (the plain version on the sample); the
        # bound counts the levels up to each lane's larger bracket
        name = "shell_depths" + sfx
        device, by = _device_ms(lambda: sf.shell_depths(*full), name + "_kernel")
        levels = _depth_levels(sample[0], sample[1], sample[4], radii) * B4 / 2**16
        bound = bound_ms(p.element_size() * B4 * 10 + 4 * B4, 5.0 * levels,
                         PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
        times = {"ms": _time_ms(lambda: sf.shell_depths(*full)), "device_ms": device,
                 "device_by": by, "plain_ms": _time_ms(lambda: shell_depths_plain(*sample), reps=5),
                 "lanes": B4, "plain_lanes": 2**16, "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"  {name} at path B's {B4} lanes: call {times['ms']:.4f} ms, device {device:.4f} "
              f"ms (by the {by}), plain {times['plain_ms']:.4f} ms on the 2^16-lane sample, "
              f"{levels / B4:.2f} levels a lane, bound {bound[0]:.4f} ms by {bound[1]}",
              flush=True)
        out[name] = (0.0, times)
    etp.set_mode("mono_single")
    names = _dual_refusals()
    print(f"  a dual into {', '.join(names)}: NotImplementedError, nothing launched",
          flush=True)
    return out


def _profiled_iteration(run, module, attr, iterations):
    """(CUDA kernels, device ms) an iteration of ``run`` over a profiler
    window of ``module.attr``'s calls (one an iteration): 8 iterations
    after the run's first sixteenth (the run ends there)."""
    window = min(8, iterations // 4)
    prof = profile_window(run, module, attr, iterations // 16, window)
    n, ms, _ = window_device(prof, window)
    return n, ms


def sensitivity_full_width(phase):
    """Phase M: c1 (76 VZA x 1048576 spp, a quarter of c1's samples) with each channel of
    :data:`SENS_C1_CHANNELS` and path B (c4 at SZA 75, 15 VZA x 2097152 spp)
    with ``medium.tau_scale``, each channel one ``sensitivities`` pass, beside
    the primal render they share (the same config: RR off, ``lr_flight``)
    in one run: walls, iterations, launches against them (K1: once an
    iteration, twice where the tables carry a tangent; path B: K2 and the
    shell depths once, K4 twice), CUDA kernels and device ms an iteration,
    busy share. The pass's radiance must equal the primal render bit for
    bit. Then path B's pass in ``mono_double`` (the float64 builds), and
    the Gauss-Newton retrieval. Returns its records."""
    import dataclasses

    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops import tracer, tracer_spherical
    from eradiate_tpu_torch.sensitivity import sensitivities

    rec = {"passes": {}}

    def case(label, exp, spp, channels, module, attr, expect, seed=SEED):
        m = exp.measures[0]
        scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
        cfg = dataclasses.replace(config, rr_depth=config.max_depth, lr_flight=True)
        n_pix = len(np.asarray(sensor.directions))
        sensitivities(exp, channels[-1:], spp=1024, seed=seed, device="cuda")  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        raw = exp._render_one(scene, sensor, cfg, spp, seed, device="cuda")
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t0
        its = raw["iterations"]
        primal = raw["radiance"].cpu().numpy()
        launches = read_launches()
        kn, kms = _profiled_iteration(
            lambda: exp._render_one(scene, sensor, cfg, spp, seed, device="cuda"), module, attr,
            its)
        print(f"[{phase}] {label}: primal render (RR off, lr_flight) {n_pix} VZA x {spp} spp, "
              f"wall {wall0:.3f} s, {its} iterations ({1e3 * wall0 / its:.3f} ms each), "
              f"{kn:.1f} kernels and {kms:.3f} device ms an iteration, busy "
              f"{kms * its / (1e3 * wall0):.3f}; launches {_nonzero(launches)}",
              flush=True)
        out = {"primal_wall_s": wall0, "iterations": its, "kernels_an_iteration": kn,
               "device_ms_an_iteration": kms}
        for ch in channels:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            (entry,) = sensitivities(exp, [ch], spp=spp, seed=seed, device="cuda").values()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            jac = entry["jac"][ch]["brf"]
            kn, kms = _profiled_iteration(
                lambda: sensitivities(exp, [ch], spp=spp, seed=seed, device="cuda"), module,
                attr, its)
            print(f"    {ch}: pass wall {wall:.3f} s ({wall / wall0:.3f}x the primal), "
                  f"{kn:.1f} kernels and {kms:.3f} device ms an iteration, busy "
                  f"{kms * its / (1e3 * wall):.3f}; launches {_nonzero(launches)}; BRF tangent "
                  f"at nadir {jac[0, n_pix // 2]:.6f}, finite {bool(np.isfinite(jac).all())}",
                  flush=True)
            for k, mult in expect(ch).items():
                if launches[k] != mult * its:
                    raise AssertionError(f"{label}, {ch}: {k} launched {launches[k]} times, not "
                                         f"{mult} x {its} iterations")
            if any(n for k, n in launches.items() if k not in expect(ch)):
                raise AssertionError(f"{label}, {ch}: a kernel of another path launched")
            if not np.array_equal(entry["radiance"], primal):
                raise AssertionError(f"{label}, {ch}: the pass's radiance differs from the "
                                     "primal render")
            if not (np.isfinite(jac).all() and np.abs(jac).max() > 0):
                raise AssertionError(f"{label}, {ch}: the tangent is not finite and non-zero")
            out[ch] = {"wall_s": wall, "ratio": wall / wall0, "launches": _nonzero(launches),
                       "kernels_an_iteration": kn, "device_ms_an_iteration": kms}
        rec["passes"][label] = out
        return out

    etp.set_mode("mono_single")
    case("c1", _c1(N_VZA), SPP_C1_QUARTER, SENS_C1_CHANNELS, tracer, "collision_fetch",
         lambda ch: {"collision_fetch": 1 if ch == "surface.reflectance" else 2})
    path_b = {"shell_flight": 1, "shell_depths": 1, "slant_tau": 2}
    case("path B", _c4(75.0), SPP_C4, ("medium.tau_scale",), tracer_spherical, "shell_flight",
         lambda ch: path_b)
    etp.set_mode("mono_double")
    case("path B, mono_double", _c4(75.0), SPP_C4, ("medium.tau_scale",), tracer_spherical,
         "shell_flight", lambda ch: {f"{k}_f64": n for k, n in path_b.items()})
    etp.set_mode("mono_single")
    rec["retrieval"] = retrieval(phase)
    return rec


def _nonzero(launches):
    return {k: n for k, n in launches.items() if n}


def _retrieval_exp(rho, scale):
    """The retrieval's scene: a homogeneous scattering and absorbing 10 km
    layer whose depth scales with ``scale``, over a Lambertian floor."""
    from eradiate_tpu_torch import AtmosphereExperiment

    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": RETRIEVAL_ZENITHS,
                  "azimuth": 0.0, "spp": RETRIEVAL_SPP, "id": "m"},
        surface={"type": "lambertian", "reflectance": float(rho)},
        atmosphere={"type": "homogeneous", "top": 10.0, "sigma_s": 0.02 * float(scale),
                    "sigma_a": 0.01 * float(scale)})


def retrieval(phase):
    """A Gauss-Newton fit of (rho, tau scale) from synthetic 5-angle BRFs at
    16384 spp with the port's Jacobians on the card (the JAX package's
    ``tests/system/test_retrieval.py``: its start, steps, damping, seeds and
    gate, |rho - 0.32| < 0.015 and |s - 1.35| < 0.08)."""
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.sensitivity import sensitivities

    t0 = time.perf_counter()
    y_obs = np.asarray(etp.run(_retrieval_exp(*RETRIEVAL_TRUTH), seed_state=etp.SeedState(123),
                               device="cuda")["brf"]).ravel()
    x = np.array(RETRIEVAL_START)
    tail = []
    for it in range(6):
        (e,) = sensitivities(_retrieval_exp(*x), ["surface.reflectance", "medium.tau_scale"],
                             seed=1000, device="cuda").values()
        J = np.stack([e["jac"]["surface.reflectance"]["brf"].ravel(),
                      e["jac"]["medium.tau_scale"]["brf"].ravel() / x[1]], axis=1)
        dx = np.linalg.solve(J.T @ J + 1e-6 * np.eye(2), J.T @ (y_obs - e["brf"].ravel()))
        x = x + np.clip(dx, -0.5, 0.5)
        x = np.array([np.clip(x[0], 0.01, 0.95), np.clip(x[1], 0.1, 3.0)])
        if it >= 3:
            tail.append(x.copy())
    x_hat = np.mean(tail, axis=0)
    wall = time.perf_counter() - t0
    err = np.abs(x_hat - np.array(RETRIEVAL_TRUTH))
    print(f"    retrieval: 6 Gauss-Newton iterations in {wall:.3f} s, (rho, tau scale) "
          f"{x_hat[0]:.5f}, {x_hat[1]:.5f} against {RETRIEVAL_TRUTH} (errors {err[0]:.5f}, "
          f"{err[1]:.5f}; bounds 0.015, 0.08)", flush=True)
    if not (err[0] < 0.015 and err[1] < 0.08):
        raise AssertionError("the retrieval did not converge to the truth")
    return {"iterations": 6, "wall_s": wall, "x_hat": x_hat.tolist()}


def _tangent_gate(label, ch, gpu, cpu, pixel, median):
    """Each pixel's tangent within ``pixel`` of the channel's largest
    |tangent| and their median within ``median``."""
    a, b = gpu["jac"][ch]["radiance"], cpu["jac"][ch]["radiance"]
    scale = np.abs(b).max()
    dev = np.abs(a - b) / scale
    print(f"    {label} {ch}: tangent max {dev.max():.3e}, median {np.median(dev):.3e} of the "
          f"largest |tangent| {scale:.4e} (bounds {pixel:g}, {median:g})", flush=True)
    if not (dev.max() <= pixel and np.median(dev) <= median):
        raise AssertionError(f"{label} {ch}: the CUDA tangent differs from the CPU's")


def sensitivity_gates(phase, cpu):
    """Phase N: the sensitivities on CUDA against the CPU at one seed: c1 at
    11 views and 256 spp (values within 1e-4 and |z| <= 5, tangents within
    1e-3 of each channel's largest |tangent|); the spherical, canopy and DEM
    scenes at 64 spp (values |z| <= 5; tangents each pixel within 1e-2 of
    the channel's largest, their median within 1e-3). Returns the CUDA
    walls."""
    walls = {}
    for case, channels in SENS_GATE_CHANNELS.items():
        gpu, wall = _sens_render(case, "cuda")
        cpu_entry, cpu_wall = cpu.get(_cpu_sens_render, "mono_single", case)
        walls[case] = wall
        a, b = gpu["radiance"], cpu_entry["radiance"]
        rel = np.abs(a - b) / np.abs(b)
        z = np.abs(a - b) / np.sqrt(np.maximum(gpu["radiance_var"] + cpu_entry["radiance_var"],
                                               1e-30))
        print(f"[{phase}] {case} sensitivities on CUDA ({wall:.2f} s) against the CPU "
              f"({cpu_wall:.2f} s): values max rel {rel.max():.3e}, max |z| {z.max():.3e}",
              flush=True)
        if z.max() > 5.0 or (case == "c1" and rel.max() > 1e-4):
            raise AssertionError(f"{case}: the CUDA values differ from the CPU's")
        for ch in channels:
            if case == "c1":
                _tangent_gate(case, ch, gpu, cpu_entry, 1e-3, 1e-3)
            else:
                _tangent_gate(case, ch, gpu, cpu_entry, 1e-2, 1e-3)
    return walls



#: The phase group whose seconds :func:`stamp` prints next, and its start.
_STAMP = {"label": "1. card", "t": None}


#: c1's gate (relative, a pixel) for a sharded render against the single one
C1_SHARDED_RTOL = 1e-5


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _sharded_ranks(label, out, device, backend, single, smi):
    """Two ranks through the dry run (``eradiate_tpu_torch.parallel.dryrun``):
    c1 at full width, SPP_C1 / 2 samples a rank, within c1's gate of the
    single render ``single`` and equal on both ranks, K1 launched once an
    iteration on each; every family at the dry run's size against its
    unsharded render under the families' gate (``dryrun.compare``)."""
    from eradiate_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    dryrun.run_ranks(2, [(1, 2)], device, backend, out, cases=("families", "c1"),
                     spp=SPP_C1 // 2, seed=SEED, timeout=400)
    wall = time.perf_counter() - t0
    worst = dryrun.compare(out, [(1, 2)])
    ranks = [np.load(Path(out) / f"c1-r{r}.npz") for r in range(2)]
    rel = np.abs(ranks[0]["radiance"] - single["radiance"]) / np.abs(single["radiance"])
    if not (_equal_bits(ranks[0]["radiance"], ranks[1]["radiance"])
            and int(ranks[0]["spp"]) == int(single["spp"]) and rel.max() <= C1_SHARDED_RTOL):
        raise AssertionError(f"{label}: c1 sharded differs from the single render by "
                             f"{rel.max():.3g} (gate {C1_SHARDED_RTOL}) or across the ranks")
    for r, raw in enumerate(ranks):
        launches = {k: int(raw[k]) for k in raw.files if k.startswith("launches_")}
        if launches != {"launches_collision_fetch": int(raw["iterations"])}:
            raise AssertionError(f"{label}: rank {r} launched {launches} in "
                                 f"{int(raw['iterations'])} iterations")
    launched = {}
    for case in dryrun.FAMILIES:
        arrays = np.load(Path(out) / f"{case}-1x2.npz")
        launched[case] = {k[len("launches_"):]: int(arrays[k]) for k in arrays.files
                          if k.startswith("launches_")}
    print(f"    {label}: c1 76 VZA x {SPP_C1 // 2} spp a rank: rank walls "
          f"{float(ranks[0]['wall_s']):.3f} s and {float(ranks[1]['wall_s']):.3f} s against "
          f"the single render's {single['wall_s']:.3f} s ({smi}); largest relative difference "
          f"{rel.max():.3g}; K1 launches {int(ranks[0]['launches_collision_fetch'])} and "
          f"{int(ranks[1]['launches_collision_fetch'])} = iterations; the dry run {wall:.1f} s",
          flush=True)
    print(f"    {label}: every family sharded against unsharded, largest relative difference "
          f"(the stratified sampler: |z|) {json.dumps(worst)}", flush=True)
    print(f"    {label}: rank 0's launches by family {json.dumps(launched)}", flush=True)
    return {"rank_walls_s": [float(r["wall_s"]) for r in ranks], "c1_max_rel": float(rel.max()),
            "worst": worst, "launched": launched, "dryrun_s": wall}


def sharded_phase(phase, smi, single):
    """O. the sharded renders (``eradiate_tpu_torch.parallel``): (a) one NCCL
    rank in this process renders c1 at full width through ``run(exp,
    mesh=make_render_mesh(1, 1))``, bit for bit phase 5's ``mesh=None``
    render ``single`` (its raw results and wall, at the same seed), K1
    launched once an iteration; (b) two ranks on the one card over gloo
    (NCCL refuses two ranks on a card) through the dry run; (c) with two
    cards, (b) on two cards over NCCL."""
    import torch
    import torch.distributed as dist

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch import parallel
    from eradiate_tpu_torch.parallel import dryrun

    etp.set_mode("mono_single")
    work = Path(__file__).resolve().parent / "build" / "sharded"
    work.mkdir(parents=True, exist_ok=True)
    store = work / "nccl_store"
    store.unlink(missing_ok=True)
    rec = {}
    parallel.initialize(f"file://{store}", 1, 0, backend="nccl", device="cuda")
    try:
        exp = dryrun.c1_experiment()
        mesh = parallel.make_render_mesh(1, 1, "cuda")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(SEED), mesh=mesh, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _nonzero(read_launches())
    finally:
        dist.destroy_process_group()
    sharded = exp.measures[0].results["raw"]
    same = all(_equal_bits(sharded[k], single[k]) for k in ("radiance", "m2"))
    print(f"[{phase}] (a) one NCCL rank: c1 76 VZA x {SPP_C1} spp through run(exp, "
          f"mesh=make_render_mesh(1, 1)): wall {wall:.3f} s against phase 5's "
          f"{single['wall_s']:.3f} s with mesh=None ({smi}); bit for bit {same}; launches "
          f"{launches} in {sharded['iterations']} iterations", flush=True)
    if not same or sharded["spp"] != single["spp"]:
        raise AssertionError(f"{phase} (a): the one-rank sharded c1 differs from mesh=None")
    if launches != {"collision_fetch": sharded["iterations"]}:
        raise AssertionError(f"{phase} (a): launches {launches} are not one K1 an iteration "
                             f"({sharded['iterations']})")
    rec["nccl_one_rank"] = {"wall_s": wall, "single_wall_s": single["wall_s"],
                            "launches": launches["collision_fetch"],
                            "iterations": sharded["iterations"]}
    print(f"[{phase}] (b) two ranks on cuda:0 over gloo", flush=True)
    rec["gloo_one_card"] = _sharded_ranks("(b)", work / "gloo", "cuda:0", "gloo", single, smi)
    if torch.cuda.device_count() >= 2:
        print(f"[{phase}] (c) two ranks on two cards over NCCL", flush=True)
        rec["nccl_two_cards"] = _sharded_ranks("(c)", work / "nccl", "cuda", "nccl", single,
                                               smi)
    else:
        print(f"[{phase}] (c) not run: {torch.cuda.device_count()} card (it needs two)",
              flush=True)
    return rec


# ---- P-Q. the command line and the canonical scenes ------------------------

#: Samples a pixel of phase P's HET01 through the command line (and of its
#: in-process twin).
SPP_P_HET01 = 65536
#: Phase Q: the seven canonical scenes that the port's tests held against
#: nothing on the card, as the reference's regression tier renders them
#: (``tests/regression/test_self_regression.py`` ``CASES``): case -> (the
#: factory of ``test_tools/test_cases``, its arguments, the tracer's gate,
#: the kernels the scene must launch). The samples a pixel are the pin's.
Q_CASES = {
    "rpv_afgl1986_brfpp": ("create_rpv_afgl1986_brfpp", {"n_vza": 19}, "plane",
                           ("collision_fetch",)),
    "het04a1_brfpp": ("create_het04a1_brfpp", {"n_vza": 19}, "canopy",
                      ("ray_leaves_nearest", "ray_leaves_occluded")),
    "het06_brfpp": ("create_het06_brfpp", {"n_vza": 19}, "canopy",
                    ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced",
                     "ray_tris_nearest_instanced", "ray_tris_occluded_instanced")),
    "ocean_grasp_coastal": ("create_ocean_grasp_coastal_no_atm", {}, "plane",
                            ("collision_fetch",)),
    "ocean_grasp_open": ("create_ocean_grasp_open_no_atm", {}, "plane", ("collision_fetch",)),
    "rami4atm_toa_brfpp": ("create_rami4atm_toa_brfpp", {"n_vza": 19}, "plane",
                           ("collision_fetch",)),
    "spherical_rpv_brfpp": ("create_spherical_rpv_brfpp", {}, "spherical", ("shell_flight",)),
}
#: The regression tier's rerun seed, and its RMSE bounds on the BRF.
Q_SEED = 7
Q_RMSE = {"spherical_rpv_brfpp": 0.35}
REGRESSION_REFS = Path(__file__).resolve().parent / "tests" / "regression_references"


def _q_scene(case, spp):
    from eradiate_tpu_torch.test_tools import test_cases

    factory, kwargs, _, _ = Q_CASES[case]
    return getattr(test_cases, factory)(spp=spp, **kwargs)


def _q_gate_spp(case):
    """Samples a pixel of a scene's gate against the CPU: the pin's, and for
    the canopies :data:`GATE_SPP` (het04a1's 22,500 disks at 512 spp take
    about 4 minutes on one CPU core)."""
    if Q_CASES[case][2] == "canopy":
        return GATE_SPP
    return int(np.load(REGRESSION_REFS / f"{case}.npz")["spp"])


def _cpu_scene_render(case, spp):
    """One render of a phase Q scene on the CPU in ``mono_single`` at
    :data:`Q_SEED` (:class:`CpuRenders`' job): its data variables as numpy
    arrays, and the seconds it took."""
    import eradiate_tpu_torch as etp

    etp.set_mode("mono_single")
    t0 = time.perf_counter()
    ds = etp.run(_q_scene(case, spp), seed_state=etp.SeedState(Q_SEED), device="cpu")
    return {k: np.asarray(ds[k]) for k in ds.data_vars}, time.perf_counter() - t0


def submit_scene_gates(cpu):
    """Queue the CPU sides of phase Q on ``cpu`` (:class:`CpuRenders`)."""
    for case in Q_CASES:
        cpu.submit(_cpu_scene_render, case, _q_gate_spp(case))


def _scene_gate(tracer, gpu, cpu):
    """The card-against-CPU gate of a tracer on radiance: plane-parallel
    every pixel within 1e-4 relative; spherical the median within 1e-4 and
    every pixel within 5e-2; canopies every pixel within 2e-3 and the median
    within 1e-4; every pixel within |z| <= 5 of the two runs' variances,
    each floored at (1e-5 x radiance)^2 as the regression tier floors them
    (the oceans' glint views have paths that all agree, and no variance).
    Returns (passed, max relative, median relative, max |z|)."""
    rad, rad_c = np.asarray(gpu["radiance"], np.float64), np.asarray(cpu["radiance"], np.float64)
    floor = (1e-5 * np.abs(rad_c)) ** 2
    var = np.maximum(np.asarray(gpu["var"]), floor) + np.maximum(np.asarray(cpu["var"]), floor)
    diff = np.abs(rad - rad_c)
    z = np.where(diff > 0, diff / np.sqrt(np.maximum(var, 1e-300)), 0.0)
    rel = diff / np.maximum(np.abs(rad_c), 1e-300)
    worst, median = float(rel.max()), float(np.median(rel))
    bound = {"plane": 1e-4, "spherical": 5e-2, "canopy": 2e-3}[tracer]
    ok = (rad.shape == rad_c.shape and np.isfinite(rad).all() and z.max() <= 5.0
          and worst <= bound and (tracer == "plane" or median <= 1e-4))
    return ok, worst, median, float(z.max())


def _cli_render(config, out, label):
    """``python -m eradiate_tpu_torch.cli render config -o out --mesh auto``
    in a subprocess with ``ERADIATE_TPU_RNG_SEED`` at :data:`SEED` (it loads
    the kernels phase 2 built): (the subprocess's wall, the render's wall
    and the kernel launches the command reports)."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ERADIATE_TPU_") and k not in ("MASTER_ADDR", "WORLD_SIZE")}
    env["ERADIATE_TPU_RNG_SEED"] = str(SEED)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "eradiate_tpu_torch.cli", "render", str(config), "-o", str(out),
         "--mesh", "auto"],
        cwd=Path(__file__).resolve().parent, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the command exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    m = re.search(r"^render: ([0-9.]+) s on cuda; kernel launches (\{.*\})$", proc.stdout, re.M)
    if m is None:
        raise AssertionError(f"{label}: no render line in the command's output: "
                             f"{proc.stdout[-2000:]}")
    return wall, float(m.group(1)), json.loads(m.group(2))


def _same_npz(a, b):
    """Whether two ``.npz`` files hold the same arrays, bit for bit."""
    a, b = np.load(a), np.load(b)
    return sorted(a.files) == sorted(b.files) and all(_equal_bits(a[k], b[k]) for k in a.files)


def _c1_config():
    """c1 (:func:`_c1` at full width) as a JSON config for the command line,
    with its samples in the measure."""
    return {
        "mode": "mono_single",
        "illumination": {"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        "measures": {"type": "mdistant", "construct": "hplane",
                     "zeniths": np.linspace(-75, 75, N_VZA).tolist(), "azimuth": 0.0,
                     "id": "m", "spp": SPP_C1},
        "surface": {"type": "lambertian", "reflectance": 0.5},
        "atmosphere": {"type": "molecular"},
        "geometry": {"type": "plane_parallel", "layer_merge_tol": 1e-3},
    }


def _het01_config(spp):
    """HET01 under the Rayleigh column (:func:`_c5`'s instanced form, its
    leaves written out from the factory's seed) as a JSON config for a
    ``CanopyAtmosphereExperiment``."""
    from eradiate_tpu_torch.test_tools.test_cases import create_het01_brfpp

    el = create_het01_brfpp().canopy.instanced_canopy_elements[0]
    cloud = el.canopy_element
    return {
        "mode": "mono_single",
        "canopy": {"type": "discrete_canopy", "size": [100.0, 100.0, 15.0],
                   "instanced_canopy_elements": [{
                       "type": "instanced",
                       "canopy_element": {
                           "type": "leaf_cloud", "positions": cloud.positions.tolist(),
                           "orientations": cloud.orientations.tolist(),
                           "radii": cloud.radii.tolist(),
                           "leaf_reflectance": float(cloud.leaf_reflectance),
                           "leaf_transmittance": float(cloud.leaf_transmittance)},
                       "instance_positions": np.atleast_2d(el.instance_positions).tolist()}]},
        "atmosphere": {"type": "molecular", "has_absorption": False},
        "illumination": {"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        "measures": {"type": "mdistant", "construct": "hplane",
                     "zeniths": np.linspace(-75, 75, N_VZA_C5).tolist(), "azimuth": 0.0,
                     "id": "m", "spp": spp},
        "surface": {"type": "lambertian", "reflectance": 0.159},
        "integrator": {"type": "volpath", "stokes": False},
    }


def cli_phase(phase, smi, c1_ds, c1_single):
    """P. the command line: c1 at full width through ``python -m
    eradiate_tpu_torch.cli render c1.json -o out.npz --mesh auto`` equal bit
    for bit to phase 5's in-process render ``c1_ds`` (the dataset's
    ``.npz``; ``c1_single``: its raw results and wall), K1 launched once an
    iteration in the subprocess; then HET01 under the Rayleigh column at
    :data:`SPP_P_HET01` spp, equal bit for bit to an in-process ``run`` of
    the same experiment at the same seed, with the same launches."""
    import torch

    import eradiate_tpu_torch as etp

    work = Path(__file__).resolve().parent / "build" / "cli"
    work.mkdir(parents=True, exist_ok=True)
    rec = {}
    (work / "c1.json").write_text(json.dumps(_c1_config()))
    c1_ds.to_npz(work / "phase5.npz")
    wall, render_wall, launches = _cli_render(work / "c1.json", work / "c1.npz", f"{phase} c1")
    same = _same_npz(work / "c1.npz", work / "phase5.npz")
    print(f"[{phase}] c1 {N_VZA} VZA x {SPP_C1} spp through the command line: the subprocess "
          f"{wall:.3f} s, its render {render_wall:.3f} s, against phase 5's {c1_single['wall_s']:.3f} "
          f"s in this process ({smi}); bit for bit {same}; launches {launches} in "
          f"{c1_single['iterations']} iterations", flush=True)
    if not same:
        raise AssertionError(f"{phase}: the command line's c1 differs from phase 5's render")
    if launches != {"collision_fetch": c1_single["iterations"]}:
        raise AssertionError(f"{phase}: c1 through the command line launched {launches}, not one "
                             f"K1 an iteration ({c1_single['iterations']})")
    rec["c1"] = {"wall_s": wall, "render_s": render_wall, "single_wall_s": c1_single["wall_s"],
                 "launches": launches}

    config = _het01_config(SPP_P_HET01)
    (work / "het01.json").write_text(json.dumps(config))
    wall, render_wall, launches = _cli_render(work / "het01.json", work / "het01.npz",
                                              f"{phase} HET01")
    cfg = json.loads((work / "het01.json").read_text())
    etp.set_mode(cfg.pop("mode"))
    exp = etp.CanopyAtmosphereExperiment(**cfg)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(exp, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    in_wall = time.perf_counter() - t0
    in_launches = _nonzero(read_launches())
    ds.to_npz(work / "het01_in_process.npz")
    same = _same_npz(work / "het01.npz", work / "het01_in_process.npz")
    print(f"[{phase}] HET01 {N_VZA_C5} VZA x {SPP_P_HET01} spp through the command line "
          f"(CanopyAtmosphereExperiment): the subprocess {wall:.3f} s, its render "
          f"{render_wall:.3f} s, in this process {in_wall:.3f} s; bit for bit {same}; launches "
          f"{launches}, in this process {in_launches}; BRF at nadir "
          f"{float(np.asarray(ds['brf'])[0, N_VZA_C5 // 2]):.6f}", flush=True)
    if not same or launches != in_launches:
        raise AssertionError(f"{phase}: HET01 through the command line differs from the "
                             "in-process render")
    for k in C5_KERNELS["instanced"]:
        if not launches.get(k):
            raise AssertionError(f"{phase}: HET01 through the command line launched no {k}")
    rec["het01"] = {"wall_s": wall, "render_s": render_wall, "in_process_s": in_wall,
                    "launches": launches}
    etp.set_mode("mono_single")
    return rec


def canonical_phase(phase, cpu):
    """Q. the seven canonical scenes that no test held on the card, in
    ``mono_single`` through ``run(..., device="cuda")`` at the pins' samples
    and the regression tier's seed: held against the pins of
    ``tests/regression_references`` by the port's ``SidakTTest`` and
    ``RMSETest`` as ``tests/regression/test_self_regression.py`` holds the
    reference, and against the CPU at the same seed under the tracer's gate
    (:func:`_scene_gate`; the canopies rendered once more at
    :data:`GATE_SPP` for it), each scene's launches printed."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.test_tools import RMSETest, SidakTTest

    etp.set_mode("mono_single")
    rec, failed = {}, []
    for case, (_, _, tracer, kernels) in Q_CASES.items():
        pin = np.load(REGRESSION_REFS / f"{case}.npz")
        spp = int(pin["spp"])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ds = etp.run(_q_scene(case, spp), seed_state=etp.SeedState(Q_SEED), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _nonzero(read_launches())
        rad, var = np.asarray(ds["radiance"]), np.asarray(ds["var"])
        floor = (1e-5 * np.abs(rad)) ** 2
        sidak = SidakTTest(value=rad, reference=pin["radiance"], variance=np.maximum(var, floor),
                           reference_variance=np.maximum(pin["var"], floor), threshold=0.01)
        rmse = RMSETest(value=np.asarray(ds["brf"]), reference=pin["brf"],
                        threshold=Q_RMSE.get(case, 0.05))
        pinned = bool(sidak.run()) & bool(rmse.run())
        gate_spp = _q_gate_spp(case)
        gpu = ds if gate_spp == spp else etp.run(_q_scene(case, gate_spp),
                                                 seed_state=etp.SeedState(Q_SEED), device="cuda")
        cpu_vars, cpu_s = cpu.get(_cpu_scene_render, case, gate_spp)
        gated, worst, median, z = _scene_gate(tracer, gpu, cpu_vars)
        missing = [k for k in kernels if not launches.get(k)]
        print(f"[{phase}] {case} ({tracer}): {rad.shape[1]} views x {rad.shape[0]} wavelengths x "
              f"{spp} spp on CUDA in {wall:.3f} s; launches {launches}; pin: Sidak least p "
              f"{sidak.metric_value:.3g} (>= {1.0 - 0.99 ** (1.0 / rad.size):.3g}), BRF RMSE "
              f"{rmse.metric_value:.3g} "
              f"(<= {Q_RMSE.get(case, 0.05)}); against the CPU at {gate_spp} spp (CPU "
              f"{cpu_s:.1f} s): max rel {worst:.3e}, median rel {median:.3e}, max |z| {z:.3g}",
              flush=True)
        if not (pinned and gated and np.isfinite(np.asarray(ds["brf"])).all()) or missing:
            failed.append(case if not missing else f"{case} (no launch of {missing})")
        rec[case] = {"wall_s": wall, "spp": spp, "launches": launches,
                     "sidak_p": float(sidak.metric_value), "rmse": float(rmse.metric_value),
                     "gate_spp": gate_spp, "max_rel": worst, "median_rel": median, "max_z": z,
                     "cpu_s": cpu_s}
    if failed:
        raise AssertionError(f"{phase}: {failed} failed their pin or their gate against the CPU")
    return rec


def stamp(label):
    """Print the seconds of the phase group that ends here (since the
    previous stamp, or the script's start) and the total so far; ``label``
    names the group that starts."""
    now = time.perf_counter()
    start = T_START if _STAMP["t"] is None else _STAMP["t"]
    print(f"[seconds] {_STAMP['label']}: {now - start:.1f} s (total {now - T_START:.1f} s)",
          flush=True)
    _STAMP.update(label=label, t=now)

def main():
    import torch

    global T_START
    T_START = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device "
              "is required", file=sys.stderr)
        return 1

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels.leaf_intersect import leaf_bvh, leaf_instanced_bvh
    from eradiate_tpu_torch.kernels.tri_intersect import tri_bvh, tri_instanced_bvh
    from eradiate_tpu_torch.ops.tracer import REGEN_LANES_TARGET, lane_partition
    from eradiate_tpu_torch.ops.tracer_canopy import LANES_TARGET as CANOPY_LANES_TARGET
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target
    from eradiate_tpu_torch.test_tools import shells

    etp.set_mode("mono_single")

    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[1] card: {smi}", flush=True)
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    stamp('2. build')
    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{lib._name}", flush=True)
    report = Path(lib._name).with_suffix(".log").read_text().strip()
    print("    " + report.replace("\n", "\n    "), flush=True)
    # the CPU sides of the canopy gates, in the order the phases need them,
    # two at a time so that phase 22 does not wait for phase 12's and 17's
    cpu = CpuRenders(workers=4)
    for mode, form, branches, stokes in (
        ("mono_single", "instanced", WOOD_BRANCHES, False),  # 12
        ("mono_single", "flat", WOOD_BRANCHES, False),
        ("mono_single", "trees", WOOD_BRANCHES, False),  # 17
        ("mono_single", "wood", 12, False),
        (POLARIZED_MODE, "instanced", WOOD_BRANCHES, True),  # 22
        (POLARIZED_MODE, "flat", WOOD_BRANCHES, True),
        (POLARIZED_MODE, "trees", WOOD_BRANCHES, True),
        ("mono_double", "instanced", WOOD_BRANCHES, False),  # 40
        ("mono_double", "flat", WOOD_BRANCHES, False),
        ("mono_polarized_double", "instanced", WOOD_BRANCHES, True),
        ("mono_double", "trees", WOOD_BRANCHES, False),  # 43
        ("mono_double", "wood", 12, False),
        ("mono_polarized_double", "trees", WOOD_BRANCHES, True),
    ):
        cpu.submit(_cpu_c5_render, mode, form, branches, stokes, None)
    for mode, stokes, variant in (("mono_single", False, "checkerboard"),  # D
                                  ("mono_single", False, "central_patch"),
                                  (POLARIZED_MODE, True, "aerosol")):
        cpu.submit(_cpu_c5_render, mode, "instanced", WOOD_BRANCHES, stokes, variant)
    # c3's (phases 25 and 31) and phases E-H's CPU sides, in a process of
    # their own: the first pool's queue takes most of the script's time
    cpu_bg = CpuRenders(workers=2)
    cpu_bg.submit(_cpu_rows_render, "ckd_single", _c3_gate, False, C3_GATE_SPP)
    cpu_bg.submit(_cpu_rows_render, "ckd_polarized_single", _c3_gate, True, C3_GATE_SPP)
    submit_sensor_gates(cpu_bg)
    submit_dem_gates(cpu_bg)
    submit_sensitivity_gates(cpu_bg)
    submit_scene_gates(cpu_bg)

    stamp('3. kernel against twin')
    # -- 3. kernel against twin ---------------------------------------------
    print("[3] collision_fetch kernel against its plain twin", flush=True)
    from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools

    c1_column = fetch_tools.column_operands()
    column_1200 = fetch_tools.column_operands(None)
    lp = lane_partition(N_VZA, SPP_C1, REGEN_LANES_TARGET["cuda"], "cpu")[0]
    B = N_VZA * lp
    err, fetch_times, fetch_bound = check_collision_fetch(
        "c1 merged column", c1_column, B, seed=0, timed=True
    )
    _, fetch_times_1200, bound_1200 = check_collision_fetch(
        "unmerged 1200-layer column", column_1200, B, seed=2, timed=True)
    rng = np.random.default_rng(4)
    cases = [
        ("c1 merged column, ragged (B % 4 = 1)", c1_column, B + 37, 0),
        ("c1 merged column, B % 4 = 2", c1_column, B + 2, 0),
        ("c1 merged column, B % 4 = 3", c1_column, B + 3, 0),
        ("c1 merged column, queries from a misaligned view", c1_column, B, 1),
        ("unmerged 1200-layer column, ragged, misaligned", column_1200, B + 37, 1),
        ("7-layer table with flat runs", fetch_tools.flat_run_operands(), 1000, 0),
        ("7-layer table with flat runs, 2^20 + 1 lanes", fetch_tools.flat_run_operands(), 2**20 + 1,
         0),
    ]
    for L, K in ((1, 3), (1200, 16), (12287, 1), (46, 16)):
        dtau = rng.uniform(0.0, 1.0, L) * (rng.uniform(size=L) > 0.2)
        levels = np.concatenate([[0.0], np.cumsum(dtau)])
        z_levels = np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 1.0, L))])
        column = tuple(np.asarray(a, np.float32)
                       for a in (z_levels, levels, rng.uniform(size=(K, L))))
        cases.append((f"random column, L = {L}, K = {K}", column, 2**20 + 3, 0))
    for i, (label, column, lanes, offset) in enumerate(cases):
        more, *_ = check_collision_fetch(label, column, lanes, seed=1 + i, offset=offset)
        err = max(err, more)
    print(f"    device time against call time (ms): L = 46 {fetch_times['device_ms']:.4f} against "
          f"{fetch_times['ms']:.4f}, L2 flushed {fetch_times['flushed_device_ms']:.4f}; L = 1200 "
          f"{fetch_times_1200['device_ms']:.4f} against {fetch_times_1200['ms']:.4f}, L2 flushed "
          f"{fetch_times_1200['flushed_device_ms']:.4f}; bound {fetch_bound[0]:.4f} and "
          f"{bound_1200[0]:.4f} by {fetch_bound[1]}", flush=True)

    stamp('4. port on CUDA against port on CPU')
    # -- 4. port on CUDA against port on CPU ----------------------------------
    rows_cuda_vs_cpu(4, "c1", _c1, 1)

    stamp('5. c1 at full width')
    # -- 5. c1 at full width --------------------------------------------------
    exp = _c1(N_VZA)
    etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1_launches = read_launches()
    launches = c1_launches["collision_fetch"]
    iterations = exp.measures[0].results["raw"]["iterations"]
    c1_single = {**exp.measures[0].results["raw"], "wall_s": wall}  # phase O's mesh=None render
    c1_ds = ds  # phase P's
    brf = np.asarray(ds["brf"])
    vza = np.asarray(ds["vza"])
    nadir = int(np.argmin(np.abs(vza)))
    samples = N_VZA * SPP_C1
    print(f"[5] c1 full width: {N_VZA} VZA x {SPP_C1} spp = {samples} samples, "
          f"{lp} lanes/pixel ({N_VZA * lp} lanes), wall {wall:.3f} s, "
          f"{samples / wall:.4e} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    collision_fetch launches {launches}, bounce iterations "
          f"{iterations}; BRF finite {bool(np.isfinite(brf).all())}, shape "
          f"{brf.shape}, BRF at VZA {vza[nadir]:.2f}: {brf[0, nadir]:.6f}; "
          f"jax imported: {'jax' in sys.modules}", flush=True)
    if not (launches > 0 and launches == iterations):
        raise AssertionError("the main path did not run through the kernel once per bounce")
    if any(n for k, n in c1_launches.items() if k != "collision_fetch"):
        raise AssertionError("c1 launched a kernel of another path")
    if brf.shape != (1, N_VZA) or not np.isfinite(brf).all():
        raise AssertionError("c1 BRF is not finite or has the wrong shape")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    in_run, fetch_times["run_device_ms"] = fetch_device_ms_in_run(
        lambda: etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(SEED), device="cuda"))
    print(f"    device time a launch inside the run (profiler records of "
          f"{KERNELS['collision_fetch']} over {in_run} launches of one more run): "
          f"{fetch_times['run_device_ms']:.4f} ms", flush=True)

    stamp('6. the shell kernels in the library')
    # -- 6. the shell kernels in the library --------------------------------
    for fn in ("shell_flight", "shell_event", "slant_tau", "ray_tris_nearest",
               "ray_tris_occluded", "ray_tris_nearest_instanced",
               "ray_tris_occluded_instanced", "ray_leaves_nearest", "ray_leaves_occluded",
               "ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced"):
        getattr(lib, fn + "_launch")
    blocks = report.split("ptxas info    : Compiling entry function ")
    print("[6] shell_flight, shell_event, slant_tau, ray_tris and ray_leaves launchers "
          "loaded; ptxas:", flush=True)
    for block in blocks:
        if any(f"{stem}_cu" in block for stem in ("shell_flight", "tri_intersect",
                                                   "leaf_intersect")):
            name = block.split("'")[1]
            regs = [ln.strip() for ln in block.splitlines() if "registers" in ln or "spill" in ln]
            print(f"    {name}: {'; '.join(regs)}", flush=True)
    from eradiate_tpu_torch.kernels import shell_flight as sf

    print("    blocks of 256 threads an SM (registers and shared memory; the flight kernels "
          f"with a float64 checkpoint every ceil(L / {sf.CHECKPOINTS}) levels): " + ", ".join(
              f"{k} {sf.blocks_per_sm(k, 232)} at L = 232, {sf.blocks_per_sm(k, 1200)} at "
              f"L = 1200" for k in ("shell_flight", "shell_event", "slant_tau")), flush=True)
    layout = sf.layout_differences(4096)
    print(f"    the wrapper's checkpoint stride and shared-memory sizes against the library's "
          f"at 1 to 4096 shells: {len(layout)} differ", flush=True)
    if layout:
        raise AssertionError(f"the shell wrappers' layout differs from the library's: {layout[:5]}")
    for kernel in ("leaf_bvh_nearest_kernel", "leaf_bvh_occluded_kernel",
                   "leaf_ibvh_nearest_kernel", "leaf_ibvh_occluded_kernel", "bvh_nearest_kernel",
                   "bvh_occluded_kernel", "tri_ibvh_nearest_kernel", "tri_ibvh_occluded_kernel",
                   "leaf_bvh_nearest_f64_kernel", "leaf_bvh_occluded_f64_kernel",
                   "leaf_ibvh_nearest_f64_kernel", "leaf_ibvh_occluded_f64_kernel"):
        if kernel not in report:
            raise AssertionError(f"the library has no {kernel}")

    stamp('7. shell kernels against their twins')
    # -- 7. shell kernels against their twins ------------------------------
    print("[7] shell_flight, slant_tau and shell_event kernels against their plain twins",
          flush=True)
    lp = lane_partition(N_VZA_C4, SPP_C4, spherical_lanes_target(N_VZA_C4, SPP_C4, "cuda"),
                        "cpu")[0]
    B4 = N_VZA_C4 * lp
    c4_args = _shell_inputs(_c4(), B4, seed=10)
    shell_errs, shell_times, shell_bounds = check_shell_kernels(
        "c4 column", c4_args, timed=True
    )
    for name, args in (
        ("c4 column, ragged", _shell_inputs(_c4(), 100_037, seed=11)),
        ("unmerged 1200-shell column", _shell_inputs(_c4(85.0, None), 2**18, seed=12)),
        ("c4 column with vacuum shells", _shell_inputs(_c4(), 2**18, seed=13, vacuum=True)),
    ):
        errs, _, _ = check_shell_kernels(name, args)
        shell_errs = {k: max(v, errs[k]) for k, v in shell_errs.items()}
    check_slant_division()
    check_flight_root()
    exp85 = _c4(85.0)
    scene85, _, _ = exp85.compile_scene(exp85.measures[0], exp85.spectral_context(exp85.measures[0]))
    sun_85 = -np.asarray(scene85.illumination.direction, np.float32)
    for column in ("232 shells", "232 shells, vacuum", "1200 shells"):
        for label, w in (("along an axis", shells.AXIS_W), ("toward the SZA 85 sun", sun_85)):
            errs, _, _ = check_shell_kernels(
                f"slant stresses, {column}, {label}",
                _slant_stress_inputs(column, w, 100_037, seed=14),
            )
            shell_errs = {k: max(v, errs[k]) for k, v in shell_errs.items()}
    for column, (radii, sigma) in shells.flight_columns(np.random.default_rng(8)).items():
        errs, _, _ = check_shell_kernels(
            f"flight stresses, {column}",
            _flight_stress_inputs(radii, sigma, sun_85, STRESS_LANES, 15))
        shell_errs = {k: max(v, errs[k]) for k, v in shell_errs.items()}

    stamp('8. c4: port on CUDA against port on CPU')
    # -- 8. c4: port on CUDA against port on CPU -----------------------------
    for sza in (75.0, 85.0):
        c4_cuda_vs_cpu(sza)

    stamp('9, 10. c4 at full width')
    # -- 9, 10. c4 at full width -------------------------------------------
    c4_launches, c4_in_run, c4_brf_nadir = c4_full_width(75.0, SPP_C4, phase=9)
    c4x_launches, c4x_in_run, _ = c4_full_width(85.0, SPP_C4, phase=10)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    stamp('11. leaf-sweep kernels against their plain versions')
    # -- 11. leaf-sweep kernels against their plain versions ----------------
    print("[11] leaf-sweep kernels against their plain versions: the flat ones "
          "(ray_leaves_nearest, ray_leaves_occluded) traverse a bounding volume hierarchy "
          "(leaf_bvh_nearest_kernel, leaf_bvh_occluded_kernel), the instanced ones a "
          "hierarchy of two levels, instance boxes above the canonical cloud's hierarchy "
          "(leaf_ibvh_nearest_kernel, leaf_ibvh_occluded_kernel)", flush=True)
    lp = lane_partition(N_VZA_C5, SPP_C5, CANOPY_LANES_TARGET["cuda"], "cpu")[0]
    B5 = N_VZA_C5 * lp
    sweep_errs, sweep_times, sweep_bounds, sweep_reach = {}, {}, {}, {}
    for form in ("instanced", "flat"):
        exp = _c5(form)
        leaves, cull, rays, *_ = _canopy_inputs(exp, B5, seed=20)
        if form == "flat":
            check_rebuild("HET01 flat", cull,
                          lambda: leaf_bvh(leaves.centers, leaves.normals, leaves.radii))
        else:
            base = leaves.canonical
            check_rebuild("HET01 instanced", cull, lambda: leaf_instanced_bvh(
                base.centers, base.normals, base.radii, leaves.offsets))
        errs, times, bounds, reach = check_sweep_kernels(
            f"HET01 {form}, the path's lane count", leaves, cull, rays, seed=20, timed=True,
            plain_lanes=PATH_PLAIN_LANES,
        )
        sweep_times.update(times)
        sweep_bounds.update(bounds)
        sweep_reach.update(reach)
        inst = form == "instanced"
        cases = [
            (f"HET01 {form}, ragged", lambda: _canopy_inputs(exp, 100_037, 21)[:3]),
            (f"HET01 {form}, rays beside the box",
             lambda: _canopy_inputs(exp, 2**16, 21, miss=True)[:3]),
            (f"random disks {form}, rays at the rims from 0.5-3 units",
             lambda: _rim_inputs(inst, 2**17, 21)),
            (f"random disks {form}, rays at the rims from 50-300 units",
             lambda: _rim_inputs(inst, 2**17, 22, far=True)),
            (f"random disks {form} with normal components of +-0, rays at the rims",
             lambda: _rim_inputs(inst, 2**17, 23, zero_normals=True)),
        ]
        if not inst:
            cases += [
                ("disk tie soup, exact ties inside a chunk and across",
                 lambda: _leaf_stress_inputs("ties", 2**17, 24)),
                ("random disks flat, zero direction components, from 0.5-3 units",
                 lambda: _leaf_stress_inputs("axes near", 2**17, 25)),
                ("random disks flat, zero direction components, from 50-300 units",
                 lambda: _leaf_stress_inputs("axes far", 2**17, 26)),
                ("random disks flat, grazing incidence",
                 lambda: _leaf_stress_inputs("grazing", 2**17, 27)),
            ]
        else:
            cases += [
                ("instanced disk tie table, exact ties inside a chunk, across chunks, "
                 "across instances and four coincident disks",
                 lambda: _instanced_stress_inputs("ties", 2**17, 24)),
                ("random disks instanced, zero direction components, from 0.5-3 units",
                 lambda: _instanced_stress_inputs("axes near", 2**17, 25)),
                ("random disks instanced, zero direction components, from 50-300 units",
                 lambda: _instanced_stress_inputs("axes far", 2**17, 26)),
                ("random disks instanced, grazing incidence",
                 lambda: _instanced_stress_inputs("grazing", 2**17, 27)),
                ("random disks instanced 200 units from the world origin, rays from near it",
                 lambda: _instanced_stress_inputs("far offsets", 2**17, 28)),
            ]
        for label, make in cases:
            more, *_ = check_sweep_kernels(label, *make(), seed=21)
            errs = {k: max(v, more[k]) for k, v in errs.items()}
        sweep_errs.update(errs)

    stamp('12. c5 scene: port on CUDA against port on CPU')
    # -- 12. c5 scene: port on CUDA against port on CPU ----------------------
    for form in ("instanced", "flat"):
        c5_cuda_vs_cpu(form, 12, cpu)

    stamp('13, 14. c5 scene at full width')
    # -- 13, 14. c5 scene at full width -------------------------------------
    c5_launches = {}
    c5_launches["instanced"], ds_inst, wall_inst = c5_full_width("instanced", SPP_C5, phase=13)
    c5_launches["flat"], ds_flat, wall_flat = c5_full_width("flat", SPP_C5, phase=14)
    c5_single = {form: {"wall_s": w, "brf_nadir": float(np.asarray(d["brf"])[0, N_VZA_C5 // 2])}
                 for form, d, w in (("instanced", ds_inst, wall_inst),
                                    ("flat", ds_flat, wall_flat))}
    rad_i, rad_f = (np.asarray(ds["radiance"]) for ds in (ds_inst, ds_flat))
    var = np.asarray(ds_inst["var"]) + np.asarray(ds_flat["var"])
    z = np.abs(rad_i - rad_f) / np.sqrt(var)
    rel = np.abs(rad_i - rad_f) / np.abs(rad_i)
    print(f"     instanced against flat: max |z| {z.max():.3e} (bound 5), max rel "
          f"{rel.max():.3e}", flush=True)
    if not z.max() <= 5.0:
        raise AssertionError("the instanced and the flat c5 scene disagree")

    stamp('15. path B: c4 with lr_flight at full width')
    # -- 15. path B: c4 with lr_flight at full width --------------------------
    lr_launches, lr_in_run = c4_lr_flight_full_width(SPP_C4, phase=15)

    with tempfile.TemporaryDirectory() as mesh_dir:
        # -- 16. triangle-sweep kernels against their plain versions ---------
        print("[16] triangle-sweep kernels against their plain versions: the flat ones "
              "(ray_tris_nearest, ray_tris_occluded) traverse a bounding volume hierarchy "
              "(bvh_nearest_kernel, bvh_occluded_kernel), the instanced ones a hierarchy of two "
              "levels, instance boxes above the canonical soup's hierarchy "
              "(tri_ibvh_nearest_kernel, tri_ibvh_occluded_kernel)", flush=True)
        for form, plain_lanes in (("trees", PATH_PLAIN_LANES), ("wood", WOOD_PATH_PLAIN_LANES)):
            exp = _c5(form, mesh_dir)
            *_, tris, cull, rays = _canopy_inputs(exp, B5, seed=30)
            if form == "wood":
                check_rebuild("c5_wood", cull, lambda: tri_bvh(tris.v0, tris.e1, tris.e2))
            else:
                trunks = tris
                check_rebuild("c5_trees trunks", cull, lambda: tri_instanced_bvh(
                    trunks.canonical.v0, trunks.canonical.e1, trunks.canonical.e2,
                    trunks.offsets))
            errs, times, bounds, reach = check_sweep_kernels(
                f"c5_{form}, the path's lane count", tris, cull, rays, seed=30,
                timed=True, plain_lanes=plain_lanes,
            )
            sweep_times.update(times)
            sweep_bounds.update(bounds)
            sweep_reach.update(reach)
            for label, B, miss in ((f"c5_{form}, ragged", 50_021, False),
                                   (f"c5_{form}, rays beside the box", 2**15, True)):
                *_, tris, cull, rays = _canopy_inputs(exp, B, seed=31, miss=miss)
                more, *_ = check_sweep_kernels(
                    label, tris, cull, rays, seed=31,
                    plain_lanes=WOOD_PLAIN_LANES if form == "wood" else PLAIN_LANES)
                errs = {k: max(v, more[k]) for k, v in errs.items()}
            for far in (False, True):
                tris, cull, rays = _edge_inputs(form == "trees", EDGE_LANES, seed=32, far=far)
                more, *_ = check_sweep_kernels(
                    f"wood skeleton {'instanced' if form == 'trees' else 'flat'}, rays at "
                    f"edges and vertices from {'50-300 m' if far else '0.5-3 m'}",
                    tris, cull, rays, seed=32,
                )
                errs = {k: max(v, more[k]) for k, v in errs.items()}
            if form == "wood":
                for kind, label in (("ties", "tie soup, exact ties inside a chunk and across"),
                                    ("axes near", "wood skeleton flat, zero direction "
                                     "components, from 0.5-3 m"),
                                    ("axes far", "wood skeleton flat, zero direction "
                                     "components, from 50-300 m")):
                    tris, cull, rays = _flat_stress_inputs(kind, EDGE_LANES, seed=33)
                    more, *_ = check_sweep_kernels(label, tris, cull, rays, seed=33)
                    errs = {k: max(v, more[k]) for k, v in errs.items()}
            else:
                for kind, label in (
                    ("ties", "instanced tie soup, exact ties inside a chunk, across chunks and "
                     "across instances (the walk meets the higher instance first)"),
                    ("axes near", "c5_trees trunks, zero direction components, from 0.5-3 m"),
                    ("axes far", "c5_trees trunks, zero direction components, from 50-300 m"),
                    ("zero normals", "c5_trees trunks with normal components of +-0, rays at "
                     "the edges"),
                    ("far offsets", "c5_trees trunks 2 km from the world origin, rays from "
                     "near it"),
                ):
                    tris, cull, rays = _instanced_tri_stress_inputs(kind, 100_037, 34, trunks)
                    more, *_ = check_sweep_kernels(label, tris, cull, rays, seed=34)
                    errs = {k: max(v, more[k]) for k, v in errs.items()}
            sweep_errs.update(errs)
        skeleton_ms = instanced_against_flat(_c5("wood", mesh_dir), B5, 30, mesh_dir,
                                             plain_lanes=2**13)

        # -- 17. tree and wood canopies: port on CUDA against port on CPU ----
        c5_cuda_vs_cpu("trees", 17, cpu)
        c5_cuda_vs_cpu("wood", 17, cpu, mesh_dir, branches=12)

        # -- 18, 19. tree and wood canopies at full width ----------------------
        c5_launches["trees"], ds_trees, wall_trees = c5_full_width("trees", SPP_C5, phase=18)
        c5_launches["wood"], ds_wood, wall_wood = c5_full_width("wood", SPP_C5, 19, mesh_dir)
    tri_single = {form: {"wall_s": w, "brf_nadir": float(np.asarray(d["brf"])[0, N_VZA_C5 // 2])}
                  for form, d, w in (("trees", ds_trees, wall_trees), ("wood", ds_wood, wall_wood))}
    nadir = N_VZA_C5 // 2
    print("     BRF at nadir: leaves alone "
          f"{np.asarray(ds_inst['brf'])[0, nadir]:.6f}, with trunks "
          f"{np.asarray(ds_trees['brf'])[0, nadir]:.6f}, with wood skeletons "
          f"{np.asarray(ds_wood['brf'])[0, nadir]:.6f}; mean over the views "
          f"{np.asarray(ds_inst['brf']).mean():.6f}, {np.asarray(ds_trees['brf']).mean():.6f}, "
          f"{np.asarray(ds_wood['brf']).mean():.6f}", flush=True)
    print(f"     instanced triangle kernels on the wood skeleton: {skeleton_ms}", flush=True)

    stamp('20-23. polarized transport (mono_polarized_single)')
    # -- 20-23. polarized transport (mono_polarized_single) ------------------
    etp.set_mode(POLARIZED_MODE)
    polarized_c1_cuda_vs_cpu(phase=20)
    pol_c1_launches, pol_fetch_ms = polarized_c1_full_width(phase=21, spp=SPP_C1_HALF)
    pol_small = {form: c5_cuda_vs_cpu(form, 22, cpu, stokes=True)
                 for form in ("instanced", "flat", "trees")}
    pol_c5_launches, pol_sweep_ms, pol_c5_stats = polarized_c5_full_width(23, ds_inst)

    stamp('24-27. c2 (mono_single) and c3 (ckd_single) through K1')
    # -- 24-27. c2 (mono_single) and c3 (ckd_single) through K1 ---------------
    etp.set_mode("mono_single")
    print("[24] collision_fetch kernel against its plain twin on c2's and c3's columns",
          flush=True)
    c2_column = fetch_tools.experiment_operands(_c2(1))
    lp2 = lane_partition(N_VZA, SPP_C2, REGEN_LANES_TARGET["cuda"], "cpu")[0]
    B2 = N_VZA * lp2
    more, c2_fetch_times, c2_fetch_bound = check_collision_fetch(
        "c2 merged column (albedo, two blend weights, depolarisation)", c2_column, B2, seed=40,
        timed=True)
    err = max(err, more)
    for label, lanes, offset in (("c2 merged column, ragged (B % 4 = 3)", B2 + 3, 0),
                                 ("c2 merged column, queries from a misaligned view", B2, 1)):
        more, *_ = check_collision_fetch(label, c2_column, lanes, seed=41, offset=offset)
        err = max(err, more)
    etp.set_mode("ckd_single")
    exp3 = _c3(1)
    scene3, _, _ = exp3.compile_scene(exp3.measures[0],
                                      exp3.spectral_context(exp3.measures[0]))
    row3 = int(np.argmax(np.asarray(scene3.medium.tau_levels)[:, -1]))
    lp3 = lane_partition(N_VZA, SPP_C3, REGEN_LANES_TARGET["cuda"], "cpu")[0]
    more, *_ = check_collision_fetch(
        f"c3 column, row {row3} of {ROWS_C3} (the most absorbing g-point)",
        fetch_tools.experiment_operands(exp3, row3), N_VZA * lp3, seed=42)
    err = max(err, more)
    etp.set_mode("mono_single")
    c2_small = rows_cuda_vs_cpu(25, "c2", _c2, 1)
    etp.set_mode("ckd_single")
    c3_small = rows_cuda_vs_cpu(25, "c3 (ckd_single, 2 g-points a bin)", _c3_gate,
                                C3_GATE_ROWS, cpu_bg, C3_GATE_SPP)
    etp.set_mode("mono_single")
    c2_launches, c2_run_ms, c2_iterations, _, _, _, c2_stats = rows_full_width(
        26, "c2", _c2(N_VZA), SPP_C2_HALF, N_VZA, 64, 48)
    etp.set_mode("ckd_single")
    c3_launches, c3_run_ms, c3_iterations, c3_rows, _, c3_wall, _ = rows_full_width(
        27, "c3 (ckd_single)", _c3(N_VZA), SPP_C3, N_VZA, 100, 48)
    if len(c3_rows) != ROWS_C3:
        raise AssertionError(f"c3 rendered {len(c3_rows)} rows, not {ROWS_C3}")

    stamp('28-31. polarized c4 (K2-K4), c2 and c3 (K1)')
    # -- 28-31. polarized c4 (K2-K4), c2 and c3 (K1) ----------------------------
    etp.set_mode(POLARIZED_MODE)
    pol_c4_small = polarized_c4_cuda_vs_cpu(28)
    pol_c4_launches, pol_c4_k2_ms = polarized_c4_full_width(29, c4_brf_nadir)
    pol_c2_small = polarized_c1_cuda_vs_cpu(30, "polarized c2", _c2)
    pol_c2_launches, pol_c2_k1_ms = polarized_c1_full_width(
        30, "polarized c2", _c2(N_VZA), SPP_C2_HALF, skip=64)
    etp.set_mode("ckd_polarized_single")
    pol_c3_small = polarized_rows_cuda_vs_cpu(31, cpu_bg)
    etp.set_mode("mono_single")

    stamp("32-37. the double modes through the float64 builds of K1-K4")
    double = double_phases(fetch_times, B4, sun_85, c3_wall)
    stamp("38-40. the leaf canopy in the double modes through K5-K7's float64 builds")
    # -- 38-40. the leaf canopy in the double modes through K5-K7's float64 builds
    canopy64 = canopy_double_phases(B5, sweep_times, pol_c5_stats, pol_c5_stats.pop("ds"),
                                    c5_single, cpu)
    stamp("41-43. canopies with triangles in the double modes through K8's and")
    # -- 41-43. canopies with triangles in the double modes through K8's and
    # K9's float64 builds
    tri64 = tri_double_phases(B5, sweep_times, tri_single, cpu)
    stamp('A-D. every surface kind of the reference, the aerosol over c4 and')
    # -- A-D. every surface kind of the reference, the aerosol over c4 and
    # the canopy
    surfaces = surface_phases(cpu, double["runs"]["c1", "mono_single"], c2_stats)
    stamp('E-H. cameras, mpdistant, the constant sky, the structured samplers')
    # -- E-H. cameras, mpdistant, the constant sky, the structured samplers
    # and the spot over the canopy
    sensors = sensor_phases(cpu_bg)
    stamp('I-K. DEM terrain: the marched heightfield and the triangulated tile')
    # -- I-K. DEM terrain: the marched heightfield and the triangulated tile
    # through K8
    dem = dem_phases(cpu_bg)
    # -- L-N. forward-mode sensitivities: the kernels' forward rules and the
    # shell depths against their plain versions, c1 and path B at full width,
    # the retrieval, CUDA against the CPU
    stamp("L. the forward rules and the shell depths")
    rules = forward_rule_phase(
        "L", N_VZA * lane_partition(N_VZA, SPP_C1, REGEN_LANES_TARGET["cuda"], "cpu")[0], B4,
        sun_85)
    stamp("M. sensitivities at full width, and the retrieval")
    sens = sensitivity_full_width("M")
    stamp("N. sensitivities on CUDA against the CPU")
    sensitivity_gates("N", cpu_bg)
    # -- O. the sharded renders: one NCCL rank, two ranks over gloo ------------
    stamp("O. the sharded renders")
    sharded = sharded_phase("O", smi, c1_single)
    # -- P. the command line: c1 at full width and HET01 -----------------------
    stamp("P. the command line")
    torch.cuda.empty_cache()  # the subprocesses share the card
    cli = cli_phase("P", smi, c1_ds, c1_single)
    # -- Q. the seven canonical scenes, against their pins and the CPU ----------
    stamp("Q. the canonical scenes")
    canonical = canonical_phase("Q", cpu_bg)
    stamp("the kernels line")
    # -- 32-37. the double modes through the float64 builds of K1-K4 -----------
    runs, path_b64, pol_c1_double = double["runs"], double["path_b"], double["pol_c1"]
    err64, fetch64_times, fetch64_bound = double["fetch"]
    shell64_errs, shell64_times, shell64_bounds = double["shells"]
    for mod in ("jax", "eradiate_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    fetch_times["c2_column"] = {**c2_fetch_times, "lanes": B2, "bound_ms": c2_fetch_bound[0],
                                "bound_by": c2_fetch_bound[1]}
    fetch_times.update(c2_launches=c2_launches["collision_fetch"], c2_run_device_ms=c2_run_ms,
                       c3_launches=c3_launches["collision_fetch"], c3_run_device_ms=c3_run_ms,
                       c3_launches_a_row=c3_rows,
                       small_launches={"c2_256spp": c2_small["collision_fetch"],
                                       "c3_256spp": c3_small["collision_fetch"]})

    # each kernel's launches on the polarized paths: the full-width runs (K1
    # on c1 and c2, K2 on c4, K7 on c5), the small CUDA runs of phase 22
    # (K5/K6 flat, K7 and K9 on the tree form), 28 (K2, K3, K4), 30 and 31
    # (K1)
    polarized = {k: {} for k in KERNELS}
    polarized["collision_fetch"]["c1_polarized"] = pol_c1_launches["collision_fetch"]
    polarized["collision_fetch"]["c2_polarized"] = pol_c2_launches["collision_fetch"]
    polarized["shell_flight"]["c4_polarized"] = pol_c4_launches["shell_flight"]
    for k in C5_KERNELS["instanced"]:
        polarized[k]["c5_polarized"] = pol_c5_launches[k]
    smaller = {f"c5_polarized_{form}_64spp": counts
               for form, counts in pol_small.items()}
    smaller.update({f"c4_polarized_{form}_256spp": counts
                    for form, counts in pol_c4_small.items()})
    smaller.update(c2_polarized_256spp=pol_c2_small, c3_polarized_256spp=pol_c3_small)
    smaller.update(c1_polarized_double_64spp=pol_c1_double)
    for k in ("ray_leaves_nearest_instanced_f64", "ray_leaves_occluded_instanced_f64"):
        polarized[k]["c5_mono_polarized"] = canopy64["launches"][k]
    for k in TRI_F64["trees"]:
        polarized[k]["c5_trees_mono_polarized_double_64spp"] = (
            tri64["extra"][k]["launches_on"].get("c5_trees_polarized_64spp", 0))
    sweep_reach.update(canopy64["reach"])
    sweep_reach.update(tri64["reach"])
    skeleton_ms.update(tri64["skeleton"])
    for label, counts in smaller.items():
        for k, n in counts.items():
            if n:
                polarized[k][label] = n
    polarized_run_ms = {"collision_fetch": {"c1": pol_fetch_ms, "c2": pol_c2_k1_ms},
                        "shell_flight": {"c4": pol_c4_k2_ms},
                        **{k: {"c5": ms} for k, ms in pol_sweep_ms.items()},
                        **{k: {"c5_mono_polarized": v["run_device_ms"]["c5_mono_polarized"]}
                           for k, v in canopy64["extra"].items()
                           if "c5_mono_polarized" in v["run_device_ms"]}}

    def entry(name, source, replaces, n, err, times, bound, in_run=None):
        """One kernel of the ``kernels`` line; ``times`` holds its call time
        (``ms``), its device time (``device_ms``), the plain version's time
        and, for the sweeps, the lane counts the two were taken at
        (``lanes``, ``plain_lanes``), for the collision fetch also its device
        time with the L2 flushed and a launch inside the c1 run; ``in_run``
        the shell kernels' (launches, ms a launch) inside a full-width run.
        A sweep's nearest hit also carries what a ray reaches of its
        hierarchy (``reach``), and the instanced triangle kernels their time
        and bound on the wood skeleton (``skeleton``). Every kernel carries
        its launches on the polarized paths (``polarized_launches``), K1, K2
        and K7 their device time a launch inside the polarized full-width
        runs by path (``polarized_run_ms``), and its launches on the surface
        phases A-D (``surface_launches``: A and B by their full-width runs,
        C and D by their small CUDA runs) and on phases E-H
        (``sensor_launches``: E-G's full-width runs and their CPU gates' CUDA
        runs, H's runs); K1 its device time a launch inside E's camera run and
        G's one-shot run, K7's any hit its times and bound on H's shadow rays
        (``spot_shadow_rays``). K1 also carries its device time a
        launch inside A and B (``surface_run_device_ms``), its times and bound on
        c2's column (``c2_column``) and its launches and device time a
        launch inside the c2 and c3 full-width runs (``c2_launches``,
        ``c2_run_device_ms``, ``c3_launches``, ``c3_run_device_ms``, and c3's
        launches a row, ``c3_launches_a_row``)."""
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": n, "max_abs_err": err, **times,
               "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
               "polarized_launches": polarized[name],
               "surface_launches": surfaces["launches"][name],
               "sensor_launches": sensors["launches"][name], **sensors.get(name, {})}
        if name == "collision_fetch":
            out.update(surface_run_device_ms=surfaces["run_device_ms"])
        if name in polarized_run_ms:
            out.update(polarized_run_ms=polarized_run_ms[name])
        if in_run is not None:
            out.update(run_ms=in_run[name][1])
        if name in sweep_reach:
            out.update(reach=sweep_reach[name])
        if name in skeleton_ms:
            out.update(skeleton=skeleton_ms[name])
        return out

    shell_src = "eradiate_tpu_torch/csrc/shell_flight.cu"
    pallas = "eradiate_tpu/ops/pallas"
    #: sweep kernel -> (source, the TPU kernel it replaces, the form that launches it)
    sweeps = {
        "ray_leaves_nearest": ("leaf", 383, "flat"),
        "ray_leaves_occluded": ("leaf", 437, "flat"),
        "ray_leaves_nearest_instanced": ("leaf", 533, "instanced"),
        "ray_leaves_occluded_instanced": ("leaf", 550, "instanced"),
        "ray_tris_nearest": ("tri", 267, "wood"),
        "ray_tris_occluded": ("tri", 311, "wood"),
        "ray_tris_nearest_instanced": ("tri", 389, "trees"),
        "ray_tris_occluded_instanced": ("tri", 404, "trees"),
    }
    def sweep64(k, line, phases=canopy64, stem="leaf"):
        """A float64 sweep build's entry: launches on its path (K5/K6 on the
        flat c5 in mono_double, K7 on c5 in mono_polarized; K8 on c5_wood
        and K9 on c5_trees in mono_double), its other paths' launches and
        device ms a launch inside the full-width runs."""
        out = entry(k, f"eradiate_tpu_torch/csrc/{stem}_intersect.cu",
                    f"{pallas}/{stem}_intersect.py:{line}", phases["launches"][k],
                    phases["errs"][k], phases["times"][k], phases["bounds"][k])
        out.update(phases["extra"][k])
        return out

    # no single PyTorch call computes any of these functions: library_ms is null
    kernels = [
        entry("collision_fetch", "eradiate_tpu_torch/csrc/collision_fetch.cu",
              f"{pallas}/collision_fetch.py:59", c1_launches["collision_fetch"], err,
              fetch_times, fetch_bound),
        entry("shell_flight", shell_src, f"{pallas}/shell_flight.py:405",
              c4_launches["shell_flight"], shell_errs["shell_flight"],
              shell_times["shell_flight"], shell_bounds["shell_flight"], c4_in_run),
        entry("shell_event", shell_src, f"{pallas}/shell_flight.py:326",
              c4x_launches["shell_event"], shell_errs["shell_event"],
              shell_times["shell_event"], shell_bounds["shell_event"], c4x_in_run),
        entry("slant_tau", shell_src, f"{pallas}/shell_flight.py:473",
              lr_launches["slant_tau"], shell_errs["slant_tau"],
              shell_times["slant_tau"], shell_bounds["slant_tau"], lr_in_run),
        *[
            entry(k, f"eradiate_tpu_torch/csrc/{stem}_intersect.cu",
                  f"{pallas}/{stem}_intersect.py:{line}", c5_launches[form][k],
                  sweep_errs[k], sweep_times[k], sweep_bounds[k])
            for k, (stem, line, form) in sweeps.items()
        ],
        # the float64 builds of the double modes: K1 on c1 (mono_double), K3 on
        # c4 at SZA 75 (mono_double), K2 and K4 on c4's path B, all at full width
        entry("collision_fetch_f64", "eradiate_tpu_torch/csrc/collision_fetch.cu",
              f"{pallas}/collision_fetch.py:59", runs["c1", "mono_double"]["launches"], err64,
              fetch64_times, fetch64_bound),
        entry("shell_flight_f64", shell_src, f"{pallas}/shell_flight.py:405",
              path_b64["shell_flight_f64"], shell64_errs["shell_flight"],
              shell64_times["shell_flight"], shell64_bounds["shell_flight"]),
        entry("shell_event_f64", shell_src, f"{pallas}/shell_flight.py:326",
              runs["c4", "mono_double"]["launches"], shell64_errs["shell_event"],
              shell64_times["shell_event"], shell64_bounds["shell_event"]),
        entry("slant_tau_f64", shell_src, f"{pallas}/shell_flight.py:473",
              path_b64["slant_tau_f64"], shell64_errs["slant_tau"],
              shell64_times["slant_tau"], shell64_bounds["slant_tau"]),
        # the leaf sweeps' float64 builds: K5/K6 on the flat c5 in mono_double,
        # K7 on c5 as bench.py builds it (mono_polarized)
        sweep64("ray_leaves_nearest_f64", 383),
        sweep64("ray_leaves_occluded_f64", 437),
        sweep64("ray_leaves_nearest_instanced_f64", 533),
        sweep64("ray_leaves_occluded_instanced_f64", 550),
        # the triangle sweeps' float64 builds: K8 on c5_wood, K9 on c5_trees,
        # both in mono_double
        sweep64("ray_tris_nearest_f64", 267, tri64, "tri"),
        sweep64("ray_tris_occluded_f64", 311, tri64, "tri"),
        sweep64("ray_tris_nearest_instanced_f64", 389, tri64, "tri"),
        sweep64("ray_tris_occluded_instanced_f64", 404, tri64, "tri"),
    ]
    for k in kernels:
        if k["name"] in dem:
            k["dem"] = dem[k["name"]]
    # the sensitivity path (phases L and M): K1's and K4's forward rules (the
    # rule's two launches timed together) and the passes' launches of K1, K2
    # and K4; the shell depths, the one kernel of this path alone
    by_name = {k["name"]: k for k in kernels}
    passes = sens["passes"]
    for sfx, pb in (("", "path B"), ("_f64", "path B, mono_double")):
        tangent = passes[pb]["medium.tau_scale"]["launches"]
        by_name["collision_fetch" + sfx]["sensitivity"] = {
            "rule": rules["collision_fetch_rule" + sfx][1]}
        by_name["slant_tau" + sfx]["sensitivity"] = {
            "rule": rules["slant_tau_rule" + sfx][1], "path_b_tau_scale_launches":
            tangent["slant_tau" + sfx], "path_b_iterations": passes[pb]["iterations"]}
        by_name["shell_flight" + sfx]["sensitivity"] = {
            "path_b_tau_scale_launches": tangent["shell_flight" + sfx]}
        err, times = rules["shell_depths" + sfx]
        kernels.append({
            "name": "shell_depths" + sfx, "route": "cuda", "source": shell_src,
            # XLA work of the reference's likelihood-ratio flight (no Pallas
            # source): the attached path depths of _shell_flight_xla
            "replaces": "eradiate_tpu/ops/spherical.py:417",
            "launches": tangent["shell_depths" + sfx], "max_abs_err": err, **times,
            "library_ms": None,
            "path_b_iterations": passes[pb]["iterations"]})
    by_name["collision_fetch"]["sensitivity"]["c1_launches"] = {
        ch: passes["c1"][ch]["launches"]["collision_fetch"] for ch in SENS_C1_CHANNELS}
    by_name["collision_fetch"]["sensitivity"]["c1_iterations"] = passes["c1"]["iterations"]
    # phase O: K1 on the sharded c1 (one NCCL rank in this process; each of
    # two ranks over gloo), every kernel's launches on rank 0 of the families
    by_name["collision_fetch"]["sharded"] = {
        "nccl_one_rank_launches": sharded["nccl_one_rank"]["launches"],
        "nccl_one_rank_iterations": sharded["nccl_one_rank"]["iterations"]}
    for case, launched in sharded["gloo_one_card"]["launched"].items():
        for k, n in launched.items():
            by_name[k].setdefault("sharded_family_launches", {})[case] = n
    # phases P and Q: the command line's renders and the canonical scenes
    for key, recs in (("cli_launches", cli), ("canonical_launches", canonical)):
        for case, r in recs.items():
            for k, n in r["launches"].items():
                by_name[k].setdefault(key, {})[case] = n
    print(f"chip_smoke total: {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
