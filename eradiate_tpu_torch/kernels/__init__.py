"""Hand-written CUDA kernels of the port, their launch wrappers and plain twins.

Sources live in ``eradiate_tpu_torch/csrc``; :mod:`._build` compiles them
with ``nvcc`` for ``sm_90a`` at first use and loads them through ``ctypes``.
Nothing is built at import time.
"""


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from . import collision_fetch as cf
    from . import leaf_intersect as li
    from . import shell_flight as sf
    from . import tri_intersect as ti

    cf.launches = cf.launches_f64 = 0
    for counts in (sf.launches, sf.launches_f64, li.launches, li.launches_f64, ti.launches,
                   ti.launches_f64):
        counts.update(dict.fromkeys(counts, 0))


def read_launches():
    """Every kernel wrapper's launch count by name (the float64 builds'
    names end in ``_f64``)."""
    from . import collision_fetch as cf
    from . import leaf_intersect as li
    from . import shell_flight as sf
    from . import tri_intersect as ti

    return {"collision_fetch": cf.launches, **sf.launches, **li.launches, **ti.launches,
            "collision_fetch_f64": cf.launches_f64,
            **{f"{k}_f64": n for k, n in sf.launches_f64.items()}, **li.launches_f64,
            **ti.launches_f64}
