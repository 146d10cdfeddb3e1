"""State/action grid construction.

JAX re-design of the reference's grid layer (SURVEY.md L1):

* ``linspace`` grids — ``test/Dynamic_Solver.m:69-75`` builds the Kirk state
  range with ``single(linspace(x_min, x_max, dx))``.
* ``sym_linspace`` grids — zero-inclusive symmetric grids. Two variants exist
  in the reference and they are *not* identical:
    - ``position-control/Solver_position.m:363-371`` always uses
      ``ceil(n/2)+1`` points per half (so ``n=200`` yields 201 points),
    - ``pos-att/Solver_pos_att.m:906-918`` uses ``ceil(n/2)+1`` on the left
      only when ``n`` is even, ``ceil(n/2)`` otherwise, and ``ceil(n/2)`` on
      the right (so ``n`` in yields exactly ``n`` out, with *different* cell
      sizes on each side of zero — the resulting axis is rectilinear, not
      uniform).

Grids are host-side (numpy) metadata: interpolation plans and policies are
precomputed from them once; no grid math happens inside the hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Grid",
    "linspace_axis",
    "sym_linspace_inclusive",
    "sym_linspace_exact",
]


def linspace_axis(lo: float, hi: float, n: int, dtype=np.float32) -> np.ndarray:
    """Uniform axis; computed in float64, cast to ``dtype``.

    Mirrors MATLAB ``single(linspace(lo, hi, n))`` (test/Dynamic_Solver.m:69).
    """
    return np.linspace(float(lo), float(hi), int(n)).astype(dtype)


def sym_linspace_inclusive(a: float, b: float, n: int, dtype=np.float32) -> np.ndarray:
    """Symmetric zero-inclusive axis, position-control variant.

    Both halves get ``ceil(n/2)+1`` points, the duplicate zero is dropped, so
    the result has ``2*ceil(n/2)+1`` points (201 for n=200).
    Reference: position-control/Solver_position.m:363-371.
    """
    if a > 0:
        raise ValueError("minimum state must be non-positive; use linspace_axis")
    half = int(np.ceil(n / 2)) + 1
    v1 = np.linspace(float(a), 0.0, half)
    v2 = np.linspace(0.0, float(b), half)[1:]
    return np.concatenate([v1, v2]).astype(dtype)


def sym_linspace_exact(a: float, b: float, n: int, dtype=np.float32) -> np.ndarray:
    """Symmetric zero-inclusive axis, pos-att variant: exactly ``n`` points.

    For even ``n`` the left half has one more point than the right, so the two
    halves have *different* uniform spacings — the axis is rectilinear.
    Reference: pos-att/Solver_pos_att.m:906-918.
    """
    if a > 0:
        raise ValueError("minimum state must be non-positive; use linspace_axis")
    half = int(np.ceil(n / 2))
    left_n = half + 1 if n % 2 == 0 else half
    v1 = np.linspace(float(a), 0.0, left_n)
    v2 = np.linspace(0.0, float(b), half)[1:]
    return np.concatenate([v1, v2]).astype(dtype)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rectilinear state grid: one strictly-ascending 1-D axis per state dim.

    Axes live on host as numpy arrays; they are static problem metadata (used
    to precompute interpolation plans, never touched per stage).
    """

    axes: tuple[np.ndarray, ...]

    def __post_init__(self):
        axes = tuple(np.asarray(ax) for ax in self.axes)
        for ax in axes:
            if ax.ndim != 1 or ax.size < 2:
                raise ValueError("each grid axis must be 1-D with >= 2 points")
            if not np.all(np.diff(ax.astype(np.float64)) > 0):
                raise ValueError("grid axes must be strictly ascending")
        object.__setattr__(self, "axes", axes)

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(ax.size for ax in self.axes)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    def is_uniform(self, axis: int, rtol: float = 1e-5) -> bool:
        d = np.diff(self.axes[axis].astype(np.float64))
        return bool(np.allclose(d, d[0], rtol=rtol))

    def meshgrid(self, dtype=np.float32) -> tuple[np.ndarray, ...]:
        """Dense ``ndgrid``-style coordinate arrays (MATLAB ``ndgrid`` order)."""
        return tuple(
            m.astype(dtype) for m in np.meshgrid(*self.axes, indexing="ij")
        )

    @staticmethod
    def from_axes(*axes: Sequence[float]) -> "Grid":
        return Grid(tuple(np.asarray(ax) for ax in axes))
