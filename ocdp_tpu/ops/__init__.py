from .backup import BackupResult, bellman_backup
from .interp import InterpPlan, axis_locate, build_plan, interp_apply, interp_eval

__all__ = [
    "BackupResult",
    "bellman_backup",
    "InterpPlan",
    "axis_locate",
    "build_plan",
    "default_impl",
    "interp_apply",
    "interp_eval",
]


def default_impl(gpu_impl: str, cpu_impl: str = "stencil") -> str:
    """Resolve ``impl='auto'`` per platform: ``gpu_impl`` on a GPU backend,
    ``cpu_impl`` (the XLA stencil by default) on the CPU. Kernels never
    fall back to the Pallas interpreter on their own; interpret mode is an
    explicit argument for tests."""
    import jax

    return gpu_impl if jax.default_backend() == "gpu" else cpu_impl
