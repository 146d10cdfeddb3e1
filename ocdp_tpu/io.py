"""Controller / solver persistence (SURVEY.md §5 checkpoint-resume).

The reference saves each channel controller to a ``.mat`` file —
``save(file_name,'F_gI','U_Optimal_id','f0_allcomb',...)``
(pos-att/Solver_pos_att.m:289) — and reloads it with ``set_controller``
(:849-884), which rebuilds 'nearest' interpolants of the per-thruster force
tables ``f*_allcomb(U_Optimal_id)``. Equivalent here: compressed npz
holding the grid axes, value table, argmin table, and the pruned
thruster-combination force matrix; loading reconstructs the same
nearest-neighbor force lookups on device.

Also provides generic mid-solve checkpointing (save/resume of the value
table between sweeps) — something the reference cannot do (its value
iteration always restarts from scratch).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from .ops.interp import nearest_eval

__all__ = [
    "ChannelController",
    "save_channel_controller",
    "load_channel_controller",
    "save_values",
    "load_values",
]


@dataclasses.dataclass(frozen=True)
class ChannelController:
    """A solved per-channel thruster policy (the ``set_controller`` object).

    ``forces`` is the pruned combination matrix, shape (n_comb, n_thrusters);
    ``argmin`` indexes it per state cell.
    """

    axes: tuple[np.ndarray, ...]
    values: np.ndarray        # converged value table
    argmin: np.ndarray        # (nx, nv, nt, nw) int
    forces: np.ndarray        # (n_comb, n_thrusters) float32

    @property
    def force_tables(self) -> np.ndarray:
        """(n_thrusters, *state_shape) per-thruster optimal force tables."""
        return np.moveaxis(self.forces[self.argmin], -1, 0)

    def thruster_forces(self, point):
        """Nearest-neighbor per-thruster forces at a state point.

        Device-side equivalent of calling the reference's 4 ``'nearest'``
        interpolants ``Opt_F_Thr*`` (Solver_pos_att.m:432-447).
        """
        tables = jnp.asarray(self.force_tables)
        out = [nearest_eval(tables[i], self.axes, point)
               for i in range(tables.shape[0])]
        return jnp.stack(out)


def save_channel_controller(path: str, ctrl: ChannelController) -> None:
    np.savez_compressed(
        path,
        n_axes=len(ctrl.axes),
        **{f"axis{i}": np.asarray(a) for i, a in enumerate(ctrl.axes)},
        values=np.asarray(ctrl.values),
        argmin=np.asarray(ctrl.argmin),
        forces=np.asarray(ctrl.forces),
    )


def load_channel_controller(path: str) -> ChannelController:
    with np.load(path) as z:
        n = int(z["n_axes"])
        return ChannelController(
            axes=tuple(z[f"axis{i}"] for i in range(n)),
            values=z["values"],
            argmin=z["argmin"],
            forces=z["forces"],
        )


def save_values(path: str, values, sweep_index: int, axes: Sequence[np.ndarray]) -> None:
    """Mid-solve checkpoint: value table + sweep count (resume support)."""
    np.savez_compressed(
        path,
        values=np.asarray(values),
        sweep_index=np.asarray(sweep_index),
        n_axes=len(axes),
        **{f"axis{i}": np.asarray(a) for i, a in enumerate(axes)},
    )


def load_values(path: str):
    with np.load(path) as z:
        n = int(z["n_axes"])
        return (jnp.asarray(z["values"]), int(z["sweep_index"]),
                tuple(z[f"axis{i}"] for i in range(n)))
