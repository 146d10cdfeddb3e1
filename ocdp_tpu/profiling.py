"""Tracing/profiling hooks (SURVEY.md §5 tracing row).

The reference wraps every backup stage and rollout in ``tic``/``toc`` prints
(Dynamic_Solver.m:87,101; Solver_pos_att.m:271,278). The JAX equivalents:

* :func:`trace` — context manager around ``jax.profiler.trace`` producing a
  TensorBoard/XProf trace of everything inside (kernel timings, memory
  traffic).
* :class:`SweepTimer` — host-side sweeps/s counter for the segmented engine
  (pass ``timer.on_segment`` to ``value_iteration_segmented``) or any
  per-check callback (``timer.on_check`` for the converged engine), printing
  the reference's per-stage line shape.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["enable_compilation_cache", "trace", "SweepTimer",
           "sweep_callback"]

# the fixed in-checkout cache location (listed in .gitignore): the path is
# part of the cache key, so it must not move between runs
_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache and return its path.

    The row/lane kernel and the big stencils take tens of seconds to
    compile; the persistent cache carries compiled executables across
    processes. ``chip_smoke.py``, ``bench.py`` and the CLI call this on
    startup. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads
    it and no directory is set here; otherwise the cache lives in
    ``.jax_cache/`` at the root of the checkout.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every nontrivial compile; kernels here are few and large
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block to ``log_dir`` (XProf format)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SweepTimer:
    """Sweeps/s + per-check error printer.

    >>> t = SweepTimer(verbose=True)
    >>> value_iteration_segmented(..., on_segment=t.on_segment)
    >>> t.sweeps_per_s
    """

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.t0 = time.perf_counter()
        self.last_t = self.t0
        self.last_sweep = 0
        self.total_sweeps = 0

    def on_segment(self, sweep_index: int, values) -> None:
        now = time.perf_counter()
        done = sweep_index - self.last_sweep
        if self.verbose and done:
            rate = done / max(now - self.last_t, 1e-9)
            print(f"sweep {sweep_index} - {now - self.last_t:.3f} seconds "
                  f"- {rate:.1f} sweeps/s")
        self.last_t = now
        self.last_sweep = sweep_index
        self.total_sweeps = sweep_index

    def on_check(self, k_s, err_f, err_u) -> None:
        """Converged-engine check callback: the reference's
        'stage %d - %f seconds - errorF %f - errorU %f' line
        (Solver_pos_att.m:278)."""
        now = time.perf_counter()
        if self.verbose:
            print(f"stage {int(k_s)} - {now - self.last_t:.6f} seconds - "
                  f"errorF {float(err_f):.6f} - errorU {float(err_u):.6f}")
        self.last_t = now

    def on_sweep(self, i) -> None:
        """Finite-engine per-sweep callback: the reference's per-stage
        'step %d - %f seconds' print (test/Dynamic_Solver.m:87,101).
        Wire via ``value_iteration_finite(on_sweep=...)`` or a model
        solve's ``verbose=`` flag."""
        now = time.perf_counter()
        if self.verbose:
            print(f"step {int(i) + 1} - {now - self.last_t:.6f} seconds")
        self.last_t = now
        self.total_sweeps = int(i) + 1

    @property
    def sweeps_per_s(self) -> float:
        dt = max(self.last_t - self.t0, 1e-9)
        return self.total_sweeps / dt


def sweep_callback(verbose: bool, kind: str = "sweep"):
    """The solver entry points' one-liner for the reference's default
    console prints: ``None`` unless ``verbose``, else a fresh
    :class:`SweepTimer`'s per-sweep (``kind='sweep'``: finite engines,
    'step %d - %f seconds') or per-check (``kind='check'``: converged
    engines, errorF/errorU line) callback."""
    if not verbose:
        return None
    t = SweepTimer(verbose=True)
    return t.on_check if kind == "check" else t.on_sweep
