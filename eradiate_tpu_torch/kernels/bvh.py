"""The sweep kernels' bounding volume hierarchy: its host build and the
plain twins of the kernels' box test and tie rule.

Shared by the flat triangle sweeps (:func:`~.tri_intersect.tri_bvh`) and the
leaf-disk sweeps, flat (:func:`~.leaf_intersect.leaf_bvh`) and instanced
(:func:`~.leaf_intersect.leaf_instanced_bvh`), whose CUDA kernels traverse it
with the device code of ``csrc/bvh.cuh``. A caller computes one
axis-aligned box per item (float32, rounded outward, so that each box
contains its item exactly) and :func:`build` returns the inner nodes, the
items' order in the leaves and the depth; the caller lays its items out in
that order. An instanced table has two levels: the canonical hierarchy, and
above it :func:`instance_level`, a hierarchy whose items are the instances,
each the canonical root box moved by its offset.

A node is one row of 16 float32 in the layout of Aila and Laine (2009), four
float4: ``(c0.lo.x, c0.hi.x, c0.lo.y, c0.hi.y)``, ``(c1.lo.x, c1.hi.x,
c1.lo.y, c1.hi.y)``, ``(c0.lo.z, c0.hi.z, c1.lo.z, c1.hi.z)`` and ``(child 0,
child 1, 0, 0)``, the children's codes as int32 bits. A code >= 0 is an inner
node; a code < 0 is the leaf ``~(first << 3 | count)``, ``count`` (0 to
:data:`LEAF`) item rows from ``first``. Row 0 is the root.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "BOX_SLACK",
    "CAP_SLACK",
    "LEAF",
    "STACK",
    "TOP_STACK",
    "box_ray",
    "build",
    "bvh_leaves",
    "bvh_leaves_reached_plain",
    "instance_level",
    "instanced_nearest_plain",
    "leaf_of_row",
    "nearest_plain",
    "nearest_record",
    "nearest_over_instances",
    "occluded_over_instances",
    "row_index",
]

#: Most items in a leaf (``kLeaf`` of the kernels).
LEAF = 4
#: Entries of the kernels' traversal stack (``kStack``): the deepest
#: hierarchy they take.
STACK = 64
#: Entries of the instanced kernels' outer stack (``kTopStack``): the deepest
#: top level (:func:`instance_level`) they take.
TOP_STACK = 16
#: Margins of the kernels' cull (``kBoxSlack``, ``kBoxCapSlack``): a box is
#: grown by BOX_SLACK times the coordinates' magnitude and the segment by
#: CAP_SLACK of the distance to the box at both ends. A triangle sliver seen
#: at a grazing angle multiplies the exact test's rounding: on the edge-ray
#: stresses from 50-300 m the worst accepted pair needed a tenth of BOX_SLACK
#: and a fifth of CAP_SLACK (its computed t 9.4e-3 of the distance before its
#: box). A leaf disk's accepted point lies on the ray's line at its computed
#: t, off its exact box by a hundredth of BOX_SLACK at most on the disk
#: stresses (``tests/test_torch_leaf_bvh.py``).
BOX_SLACK = 1e-4
CAP_SLACK = 5e-2

_BINS = 16  # SAH bins per axis of the build

#: Most rays (lanes x instances) the instanced plain sweeps hand their flat
#: sweep at once: the few lanes of a CPU render take every instance in one
#: call (the flat sweeps cost a few operations a chunk whatever the rays),
#: and 4096 or more lanes one instance a call, each call's [rays, chunk]
#: temporaries as large as before.
INSTANCE_BATCH_RAYS = 4096


def _round_down(x):
    """float64 -> the largest float32 not above it."""
    y = x.astype(np.float32)
    above = y.astype(np.float64) > x
    y[above] = np.nextafter(y[above], np.float32(-np.inf))
    return y


def _round_up(x):
    """float64 -> the smallest float32 not below it."""
    y = x.astype(np.float32)
    below = y.astype(np.float64) < x
    y[below] = np.nextafter(y[below], np.float32(np.inf))
    return y


def _half_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _sah_split(cent, lo, hi, seg, lens):
    """One level of the build: for each of ``S`` segments (the elements of
    segment ``s`` are the rows with ``seg == s``, contiguous, ``lens[s]`` of
    them), the binned surface-area split over all three axes; returns a
    bool per element, True for the right side."""
    S = lens.size
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cmin = np.minimum.reduceat(cent, off, axis=0)
    cmax = np.maximum.reduceat(cent, off, axis=0)
    best = np.full(S, np.inf)
    best_axis = np.zeros(S, np.int64)
    best_bin = np.zeros(S, np.int64)
    bins = np.empty(cent.shape, np.int64)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    for ax in range(3):
        ext = cmax[:, ax] - cmin[:, ax]
        scale = np.where(ext > 0, _BINS / np.where(ext > 0, ext, 1.0), 0.0)
        b = np.minimum(((cent[:, ax] - cmin[seg, ax]) * scale[seg]).astype(np.int64), _BINS - 1)
        bins[:, ax] = b
        key = torch.from_numpy(seg * _BINS + b)[:, None].expand(-1, 3)
        blo = torch.full((S * _BINS, 3), np.inf, dtype=torch.float64)
        bhi = torch.full((S * _BINS, 3), -np.inf, dtype=torch.float64)
        blo = blo.scatter_reduce_(0, key, lo_t, "amin").numpy().reshape(S, _BINS, 3)
        bhi = bhi.scatter_reduce_(0, key, hi_t, "amax").numpy().reshape(S, _BINS, 3)
        count = np.bincount(seg * _BINS + b, minlength=S * _BINS).reshape(S, _BINS)
        n_left = np.cumsum(count, axis=1)[:, :-1]
        n_right = lens[:, None] - n_left
        left = _half_area(np.minimum.accumulate(blo, axis=1)[:, :-1],
                          np.maximum.accumulate(bhi, axis=1)[:, :-1])
        right = _half_area(np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1][:, 1:],
                           np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1][:, 1:])
        cost = np.where((n_left > 0) & (n_right > 0), left * n_left + right * n_right, np.inf)
        i = np.argmin(cost, axis=1)
        c = cost[np.arange(S), i]
        better = c < best  # strict: the lowest axis wins a tie
        best[better], best_axis[better], best_bin[better] = c[better], ax, i[better]
    rows = np.arange(seg.size)
    side = bins[rows, best_axis[seg]] > best_bin[seg]
    # every centroid of the segment in one place: split it at its middle
    middle = rows - off[seg] >= (lens // 2)[seg]
    return np.where(np.isfinite(best)[seg], side, middle)


def build(item_lo, item_hi, name, stack=None):
    """The hierarchy over items with boxes ``item_lo``, ``item_hi`` [N, 3]
    (float32 numpy, N >= 1): returns ``(nodes [M, 16] float32, perm [N],
    depth)``, the leaves holding the items ``perm`` in that order and
    ``depth`` inner nodes on the longest path from the root to a leaf.

    Binned surface-area heuristic (16 bins on each axis, level by level):
    splits a node until it holds at most :data:`LEAF` items. Each item is
    referenced once. A child's box is the union of its items' boxes, so a
    parent's box is the exact union of its children's. Deterministic: the
    same boxes give the same bytes. Raises (naming ``name``) if the tree is
    deeper than ``stack`` (default :data:`STACK`)."""
    N = item_lo.shape[0]
    lo64, hi64 = item_lo.astype(np.float64), item_hi.astype(np.float64)
    cent = 0.5 * (lo64 + hi64)

    perm = np.arange(N)
    levels = []  # per level: (inner node ids [S], child starts [S, 2], child ends [S, 2], codes)
    ids = np.array([0])
    starts, ends = np.array([0]), np.array([N])
    n_nodes = 1
    if N <= LEAF:  # a root with one leaf and one empty one
        cs, ce = np.array([[0, N]]), np.array([[N, N]])
        levels.append((ids, cs, ce, ~((cs << 3) | (ce - cs))))
        starts = starts[:0]
    while starts.size:
        lens = ends - starts
        seg = np.repeat(np.arange(starts.size), lens)
        pos = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) + starts[seg]
        el = perm[pos]
        right = _sah_split(cent[el], lo64[el], hi64[el], seg, lens)
        perm[pos] = el[np.argsort(seg * 2 + right, kind="stable")]
        n_left = lens - np.bincount(seg, weights=right, minlength=starts.size).astype(np.int64)
        cs = np.stack([starts, starts + n_left], axis=1)
        ce = np.stack([starts + n_left, ends], axis=1)
        inner = ce - cs > LEAF
        child = np.zeros(cs.shape, np.int64)
        child[inner] = n_nodes + np.arange(int(inner.sum()))
        n_nodes += int(inner.sum())
        levels.append((ids, cs, ce, np.where(inner, child, ~((cs << 3) | (ce - cs)))))
        ids, starts, ends = child[inner], cs[inner], ce[inner]
    depth = len(levels)
    stack = STACK if stack is None else stack
    if depth > stack:
        raise ValueError(f"{name}: the tree is {depth} deep, the kernels' stack holds {stack}")

    # children's boxes: unions of their items' boxes over their ranges (the
    # ranges of one level are disjoint; a sentinel row closes the last)
    lo_p = np.concatenate([item_lo[perm], item_lo[:1]])
    hi_p = np.concatenate([item_hi[perm], item_hi[:1]])
    nodes = np.zeros((n_nodes, 16), np.float32)
    for ids, cs, ce, codes in levels:
        order = np.argsort(cs.ravel(), kind="stable")
        bounds = np.stack([cs.ravel()[order], ce.ravel()[order]], axis=1).ravel()
        box_lo = np.empty((cs.size, 3), np.float32)
        box_hi = np.empty((cs.size, 3), np.float32)
        filled = ce.ravel()[order] > cs.ravel()[order]
        box_lo[order] = np.where(filled[:, None], np.minimum.reduceat(lo_p, bounds)[::2], 0.0)
        box_hi[order] = np.where(filled[:, None], np.maximum.reduceat(hi_p, bounds)[::2], 0.0)
        box_lo, box_hi = box_lo.reshape(-1, 2, 3), box_hi.reshape(-1, 2, 3)
        if not filled.all():  # the empty leaf takes its sibling's box
            box_lo[:, 1], box_hi[:, 1] = box_lo[:, 0], box_hi[:, 0]
        for c in range(2):
            nodes[ids, 4 * c] = box_lo[:, c, 0]
            nodes[ids, 4 * c + 1] = box_hi[:, c, 0]
            nodes[ids, 4 * c + 2] = box_lo[:, c, 1]
            nodes[ids, 4 * c + 3] = box_hi[:, c, 1]
            nodes[ids, 8 + 2 * c] = box_lo[:, c, 2]
            nodes[ids, 9 + 2 * c] = box_hi[:, c, 2]
        nodes[ids, 12:14] = codes.astype(np.int32).view(np.float32)
    return nodes, perm, depth


def _child_boxes(n):
    """The children's boxes of nodes ``n`` [M, 16] (numpy): ``lo``, ``hi``
    [M, 2, 3]."""
    lo = np.stack([n[:, [0, 4]], n[:, [2, 6]], n[:, [8, 10]]], axis=-1)
    hi = np.stack([n[:, [1, 5]], n[:, [3, 7]], n[:, [9, 11]]], axis=-1)
    return lo, hi


def bvh_leaves(bvh):
    """The leaves of a hierarchy (its ``nodes`` tensor, or anything with
    one), in the order of the child slots that hold them: ``(first [L],
    count [L], lo [L, 3], hi [L, 3])`` numpy arrays, ``count`` item rows
    from ``first``, and the leaf's box."""
    n = (bvh.nodes if hasattr(bvh, "nodes") else bvh).cpu().numpy()
    lo, hi = (x.reshape(-1, 3) for x in _child_boxes(n))
    code = np.ascontiguousarray(n[:, 12:14]).view(np.int32).ravel()
    leaf = code < 0
    code = ~code[leaf]
    return code >> 3, code & 7, lo[leaf], hi[leaf]


def instance_level(nodes, offsets, name):
    """The top level of a two-level hierarchy: one item per instance of the
    canonical hierarchy ``nodes`` [M, 16] (float32 numpy, root in row 0)
    translated by ``offsets`` [I, 3] (float32 or float64 numpy, I >= 1).
    Returns ``(top [T, 16], instances [I, 4], depth)``: the nodes of
    :func:`build` over the instance boxes; the offsets in its leaf order, in
    their dtype, each with its original row's int32 (int64 for float64)
    bits in column 3; and the depth, at most
    :data:`TOP_STACK` (raises beyond, naming ``name``).

    An instance's box is the canonical root box (the union of the root's two
    child boxes) plus its offset, grown by ``BOX_SLACK |o|_1``, computed in
    float64 and rounded outward to float32. The kernels test the world ray
    ``p`` against the instance box with the margin ``BOX_SLACK (dist +
    |p|_1)``, and the translated ray ``fl(p - o)`` against the canonical
    boxes with ``BOX_SLACK (dist' + |p - o|_1)``. Since ``|p - o|_1 <=
    |p|_1 + |o|_1``, the growth makes the world test's margin at least the
    translated one's, which covers the exact test's rounding and ``fl(p -
    o)``'s own (a few ulp of ``|p - o|``) many times over: every pair the
    exact test accepts in an instance frame lies in an instance box the
    world ray reaches."""
    lo, hi = _child_boxes(nodes[:1])
    root_lo = lo[0].min(axis=0).astype(np.float64)
    root_hi = hi[0].max(axis=0).astype(np.float64)
    o = offsets.astype(np.float64)
    grow = BOX_SLACK * np.abs(o).sum(axis=1, keepdims=True)
    top, perm, depth = build(_round_down(root_lo + o - grow), _round_up(root_hi + o + grow),
                             name, TOP_STACK)
    instances = np.zeros((offsets.shape[0], 4), offsets.dtype)
    instances[:, :3] = offsets[perm]
    index = np.int32 if offsets.dtype == np.float32 else np.int64
    instances[:, 3] = perm.astype(index).view(offsets.dtype)
    return top, instances, depth


def _box_reach(p, d, cap, lo, hi):
    """The kernels' slab test in float32: can the segment ``p + t d``, t in
    [-slack, cap + slack], reach the box grown by ``delta``? ``p``, ``d``
    [B, 3], ``cap`` [B], ``lo``, ``hi`` [L, 3]; returns bool [B, L].

    ``dist`` bounds the L1 distance from ``p`` to any point of the box;
    ``delta = BOX_SLACK (dist + |p|_1)`` and ``slack = CAP_SLACK dist +
    1e-6`` are the margins of the exact test's rounding. The near and far
    planes follow the sign of ``1 / d``; a zero component gives +-inf, and
    an origin on a grown face of such an axis gives ``0 * inf = NaN``, which
    ``fmax``/``fmin`` drop: the axis then bounds nothing (NaN counts as
    reached). Monotone under box containment, so a box that is reached has
    every ancestor reached."""
    f32 = torch.float32
    grow = torch.tensor(BOX_SLACK, dtype=f32)
    cap_slack = torch.tensor(CAP_SLACK, dtype=f32)
    tiny = torch.tensor(1e-6, dtype=f32)
    inv = 1.0 / d
    a = lo[None] - p[:, None]  # [B, L, 3]
    b = hi[None] - p[:, None]
    far_side = torch.fmax(-a, b)
    dist = (far_side[..., 0] + far_side[..., 1]) + far_side[..., 2]
    ap = torch.abs(p)
    l1 = ((ap[:, 0] + ap[:, 1]) + ap[:, 2])[:, None]
    delta = grow * (dist + l1)
    slack = cap_slack * dist + tiny
    a = a - delta[..., None]
    b = b + delta[..., None]
    neg = (inv < 0)[:, None, :]
    near = torch.where(neg, b, a) * inv[:, None, :]
    far = torch.where(neg, a, b) * inv[:, None, :]
    t_near = torch.fmax(torch.fmax(torch.fmax(near[..., 0], near[..., 1]), near[..., 2]), -slack)
    t_far = torch.fmin(torch.fmin(torch.fmin(far[..., 0], far[..., 1]), far[..., 2]),
                       cap[:, None] + slack)
    return t_near <= t_far


def box_ray(p, d, cap):
    """The ray and cap the kernels' box test reads: float32 as they are; a
    float64 ray (the float64 builds) rounded to the nearest float32 and its
    cap rounded up. The shift, 6e-8 of the coordinates and of the distance
    travelled, lies far inside the test's margins."""
    if p.dtype == torch.float32:
        return p, d, cap
    cap32 = cap.float()
    below = cap32.double() < cap
    cap32 = torch.where(below, torch.nextafter(cap32, torch.full_like(cap32, np.inf)), cap32)
    return p.float(), d.float(), cap32


def row_index(rows):
    """The original indices of a leaf-ordered item array's rows, from the
    bits of its column 3 (int32 in a float32 array, int64 in a float64 one):
    a list of ints."""
    bits = torch.int32 if rows.dtype == torch.float32 else torch.int64
    return rows[:, 3].contiguous().view(bits).tolist()


def bvh_leaves_reached_plain(p, d, cap, bvh):
    """Which leaves of :func:`bvh_leaves` the kernels' cull reaches for rays
    ``p``, ``d`` [B, 3] with caps ``cap`` [B] (float32, or float64 rounded
    by :func:`box_ray`): bool [B, L]. The plain twin of the kernels' box
    test (same margins, same NaN rule), applied to each leaf's own box."""
    _, _, lo, hi = bvh_leaves(bvh)
    return _box_reach(*box_ray(p, d, cap), *(torch.from_numpy(x).to(p.device) for x in (lo, hi)))


def leaf_of_row(bvh, n_rows):
    """The leaf (index into :func:`bvh_leaves`) that holds each of the
    ``n_rows`` item rows of a hierarchy: int64 numpy [n_rows]."""
    row_leaf = np.empty(n_rows, np.int64)
    for leaf, (first, count) in enumerate(zip(*bvh_leaves(bvh)[:2])):
        row_leaf[first : first + count] = leaf
    return row_leaf


def nearest_record(t_max, n_items, test, order=None, index_order=None):
    """A nearest-hit kernel's running record as it computes it, whatever
    the order of its visits: items ``0 .. n_items - 1`` visited one at a
    time in ``order`` (default index order). ``test(k)`` gives item ``k``'s
    exact distances [B] (+inf where missed, or where the kernel's cull does
    not reach it), its normal [3] and its tie key (an int). The order-free
    tie rule: a hit replaces the best when its ``t`` is smaller, or equal
    with a lower key; it adds its normal when ``t`` and key are equal.
    Float32 normals are summed in float64 from zero, which is exact in any
    order. Float64 normals (``t_max`` float64) are summed from zero in
    float64 in the reference's order, the items' original order
    ``index_order`` (a permutation of the items, default index order), in a
    second pass over the winners, as the float64 kernels sum three or more
    tied normals (two are summed alike in either order). Returns ``(t_hit
    [B], normal [B, 3], hit [B])``."""
    B, device = t_max.shape[0], t_max.device
    best_t = t_max.clone()
    best_key = torch.full((B,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    total = torch.zeros((B, 3), dtype=torch.float64, device=device)
    cnt = torch.zeros(B, dtype=torch.int64, device=device)
    for k in range(n_items) if order is None else order:
        t, n, key = test(int(k))
        found = torch.isfinite(t)
        if not found.any():
            continue
        tie = found & (t == best_t)
        replace = found & ((t < best_t) | (tie & (key < best_key)))
        add = tie & (key == best_key)
        n = n.double()
        total = torch.where(replace[:, None], 0.0 + n, torch.where(add[:, None], total + n, total))
        cnt = torch.where(replace, 1, cnt + add.long())
        best_t = torch.where(replace, t, best_t)
        best_key = torch.where(replace, key, best_key)
    hit = cnt > 0
    dtype = t_max.dtype
    if dtype == torch.float64:
        total = torch.zeros((B, 3), dtype=torch.float64, device=device)
        for k in range(n_items) if index_order is None else index_order:
            t, n, key = test(int(k))
            add = torch.isfinite(t) & (t == best_t) & (key == best_key)
            total = torch.where(add[:, None], total + n, total)
    normal = total.to(dtype) / torch.clamp(cnt, min=1)[:, None].to(dtype)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    normal = torch.where(hit[:, None], normal, up)
    return torch.where(hit, best_t, t_max), normal, hit


def nearest_plain(p, d, t_max, bvh, rows, test, order=None, chunk=512):
    """A flat nearest-hit kernel's result as it computes it: the item
    ``rows`` of ``bvh`` (its leaf-ordered item array, the original index's
    int32 bits in column 3) visited one at a time in ``order`` (default
    their leaf order), each ray testing only those in leaves its cull
    reaches with the cap ``t_max``. ``test(k)`` gives row ``k``'s exact
    distances [B] (+inf where missed) and its normal [3]. The tie key is
    the original index // ``chunk`` (:func:`nearest_record`)."""
    row_leaf = leaf_of_row(bvh, rows.shape[0])
    reached = bvh_leaves_reached_plain(p, d, t_max, bvh)
    index = row_index(rows)

    def visit(k):
        t, n = test(k)
        return torch.where(reached[:, int(row_leaf[k])], t, torch.inf), n, index[k] // chunk

    return nearest_record(t_max, rows.shape[0], visit, order, np.argsort(index))


def _instance_batches(p, d, t_max, offsets):
    """The rays translated into each instance's frame (``p - offset``), in
    batches of whole instances of at most :data:`INSTANCE_BATCH_RAYS` rays
    (one instance at least): yields ``(k, p', d', t_max')``, the batch's ``k``
    instances' rays one instance after the other."""
    B = p.shape[0]
    per = max(1, INSTANCE_BATCH_RAYS // max(B, 1))
    for start in range(0, offsets.shape[0], per):
        off = offsets[start : start + per]
        k = off.shape[0]
        yield k, (p[None] - off[:, None]).reshape(k * B, 3), d.repeat(k, 1), t_max.repeat(k)


def nearest_over_instances(p, d, t_max, offsets, flat_nearest):
    """Nearest hit against the copies of a table translated by ``offsets``
    [I, 3]: ``flat_nearest(p', d', t_max')`` (a flat sweep's ``(t, normal,
    hit)``) swept in every instance's frame with the cap ``t_max``, batches
    of instances at once, and the hits kept in instance order where their
    ``t`` is below the best so far. That equals sweeping each instance with
    the running best as its cap: a hit at or beyond the best is never kept,
    and below it the two sweeps find the same nearest hit, chunk and tied
    normals."""
    B = p.shape[0]
    best_t = t_max
    best_n = torch.zeros((B, 3), dtype=p.dtype, device=p.device)
    best_n[:, 2] = 1.0
    hit = torch.zeros(B, dtype=torch.bool, device=p.device)
    for k, pj, dj, tj in _instance_batches(p, d, t_max, offsets):
        t, n, h = flat_nearest(pj, dj, tj)
        for i in range(k):
            sl = slice(i * B, (i + 1) * B)
            better = h[sl] & (t[sl] < best_t)
            best_t = torch.where(better, t[sl], best_t)
            best_n = torch.where(better[:, None], n[sl], best_n)
            hit = hit | better
    return torch.where(hit, best_t, t_max), best_n, hit


def occluded_over_instances(p, d, t_max, offsets, flat_occluded):
    """Any hit against the translated copies: ``flat_occluded(p', d',
    t_max')`` in every instance's frame, batches of instances at once."""
    B = p.shape[0]
    occ = torch.zeros(B, dtype=torch.bool, device=p.device)
    for k, pj, dj, tj in _instance_batches(p, d, t_max, offsets):
        occ = occ | flat_occluded(pj, dj, tj).reshape(k, B).any(dim=0)
    return occ


def instanced_nearest_plain(p, d, t_max, ibvh, rows, hits, normals, order=None, chunk=512):
    """An instanced nearest-hit kernel's result as it computes it: the
    (instance, item) pairs of the two-level hierarchy ``ibvh`` (its
    ``top``, ``instances`` and ``canonical`` level, whose leaf-ordered item
    array is ``rows``, the original index's int32 bits in column 3) visited
    one at a time in ``order`` (a permutation of ``range(I * N)``, pair ``j
    * N + k`` being row ``j`` of ``ibvh.instances`` and row ``k`` of
    ``rows``; default the leaf order of both levels), each ray testing only
    the pairs whose top leaf it reaches with the world ray and whose
    canonical leaf it reaches with the translated ray ``p - offset``, both
    with the cap ``t_max``. ``hits(pj)`` gives the exact distances [B, N] of
    the translated rays ``pj`` against ``rows`` (+inf where missed) and
    ``normals`` [N, 3] their normals. The tie key is ``instance * ceil(N /
    chunk) + index // chunk``, the instance being the offset's original row
    (:func:`nearest_record`)."""
    canon = ibvh.canonical
    N, I = rows.shape[0], ibvh.instances.shape[0]
    chunks = -(-N // chunk)
    index = row_index(rows)
    inst_rows = row_index(ibvh.instances)
    item_leaf = torch.from_numpy(leaf_of_row(canon, N)).to(p.device)
    top_reached = bvh_leaves_reached_plain(p, d, t_max, ibvh.top)
    top_reached = top_reached[:, torch.from_numpy(leaf_of_row(ibvh.top, I)).to(p.device)]
    t = []
    for j in range(I):
        pj = p - ibvh.instances[j, :3]
        reached = bvh_leaves_reached_plain(pj, d, t_max, canon)[:, item_leaf]
        reached &= top_reached[:, j : j + 1]
        t.append(torch.where(reached, hits(pj), torch.inf))

    def visit(m):
        j, k = divmod(m, N)
        return t[j][:, k], normals[k], inst_rows[j] * chunks + index[k] // chunk

    originals = np.add.outer(np.asarray(inst_rows) * N, index).reshape(-1)
    return nearest_record(t_max, I * N, visit, order, np.argsort(originals))
