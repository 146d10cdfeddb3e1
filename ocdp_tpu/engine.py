"""Backward value-iteration engines (SURVEY.md L4).

Two drivers, mirroring the reference's two loop shapes:

* :func:`value_iteration_finite` — fixed number of backward sweeps with an
  optional per-sweep policy store; the Kirk finite-horizon loop
  (test/Dynamic_Solver.m:86-102). Runs as one ``lax.scan`` with the value
  table as donated carry, so the whole solve is a single XLA computation.

* :func:`value_iteration_converged` — value iteration with the pos-att
  early-stopping rule: every ``check_every`` sweeps compare the summed value
  table against the previous checkpoint and stop when ``|Δ| < tol``
  (pos-att/Solver_pos_att.m:268-286). Runs as one ``lax.while_loop``;
  steady-state problems keep only the final policy, like the reference.

Stage-loop semantics note: sweep ``j=0`` is the backup from the terminal cost
(the reference's ``k = 1`` / ``k_s = N-1``), so for finite-horizon rollout at
forward stage ``k`` (0-based) the policy to use is ``policies[N-2-k]``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops.backup import bellman_backup
from .ops.interp import InterpPlan

__all__ = [
    "SolveResult",
    "value_iteration_finite",
    "value_iteration_converged",
    "value_iteration_segmented",
    "policy_dtype_for",
    "convergence_stop",
]


def convergence_stop(err_f, fsum, tol: float, tol_mode: str = "abs"):
    """The early-stop predicate evaluated at each periodic checkpoint.

    * ``'abs'`` — ``|Δ Σ V| < tol``: the reference's rule verbatim
      (pos-att/Solver_pos_att.m:280). Scale-DEPENDENT: at the reference's
      own defaults (tol=1e-2 against checksums ~1e6) it never fires inside
      the sweep cap — matching the reference's actual behavior, where the
      loop always runs to the cap (NOTES.md parity ledger).
    * ``'rel'`` — ``|Δ Σ V| < tol * max(|Σ V|, 1)``: normalized/scale-free
      stop, BEYOND reference parity. ``tol`` then reads as "the summed
      value function is stable to ``tol`` relative precision per check
      window" — a physically-motivated rule that actually fires (e.g. the
      flagship 6-D attitude family converges to 1e-6 relative in well under
      its 5999-sweep cap; see bench.py attitude_6d_converged).

    Shared by every converged engine (single-chip, replicated-sharded,
    halo, halo6, channel-EP) so the stop decision is identical across
    parallelism strategies. ``tol_mode`` is validated at trace time.
    """
    if tol_mode == "abs":
        return jnp.abs(err_f) < tol
    if tol_mode == "rel":
        return jnp.abs(err_f) < tol * jnp.maximum(jnp.abs(fsum), 1.0)
    raise ValueError(f"unknown tol_mode {tol_mode!r}; use 'abs' or 'rel'")


class SolveResult(NamedTuple):
    values: jax.Array            # final value table V, state-grid shape
    # flat-action argmin of the LAST sweep: int32 by default; engines called
    # with narrow_argmin_result=True return the narrow policy dtype instead
    # (uint8/int16 via policy_dtype_for — the envelope-scale output buffer)
    argmin: jax.Array
    policies: Optional[jax.Array]  # (num_sweeps, *state_shape) or None
    num_sweeps: jax.Array        # actual sweeps performed (scalar int32)
    converged: jax.Array         # bool scalar (always False for finite driver)
    probes: Optional[jax.Array] = None  # (num_sweeps, *window) V probes or None
    # converged-engine check log, (n_checks, 3): [k_s, errorF, errorU] per
    # convergence check (the reference's per-50-stage print,
    # Solver_pos_att.m:272-279); rows past the stop point hold zeros
    checks: Optional[jax.Array] = None


def policy_dtype_for(n_actions: int):
    """Smallest integer dtype that can index ``n_actions`` actions.

    The reference plans uint8 argmin storage for the same reason
    (Solver_attitude.m:189-191).
    """
    if n_actions <= np.iinfo(np.uint8).max + 1:
        return jnp.uint8
    if n_actions <= np.iinfo(np.int16).max + 1:
        return jnp.int16
    return jnp.int32


def value_iteration_finite(
    plan: InterpPlan,
    stage_cost: jax.Array,
    num_sweeps: int,
    *,
    init_values: Optional[jax.Array] = None,
    store_policies: bool = False,
    policy_dtype=None,
    backup=None,
    probe_window=None,
    narrow_argmin_result: bool = False,
    on_sweep=None,
) -> SolveResult:
    """Run exactly ``num_sweeps`` Bellman backups (finite-horizon DP).

    ``num_sweeps`` is the reference's ``N-1`` (terminal cost J_N = 0 is the
    initial table; each sweep produces the previous stage's value/policy).

    ``backup``: optional callable ``values -> BackupResult`` replacing the
    default gather-based fused backup — e.g. a
    :class:`~ocdp_tpu.ops.stencil.StencilBackup`.

    ``probe_window``: optional tuple of ``(start, size)`` per state dim; the
    engine then captures that window of V after every sweep (the reference's
    ``checkstagesXJF`` probes, test/Dynamic_Solver.m:212-219) into
    ``SolveResult.probes``.

    ``narrow_argmin_result``: return ``SolveResult.argmin`` in the narrow
    policy dtype (uint8 at <= 256 actions) instead of widening to int32 —
    the int32 OUTPUT buffer alone is multi-GB at envelope grids.

    ``on_sweep(i)``: optional host callback fired after each sweep via
    ``jax.debug.callback`` — the reference's per-stage
    ``'step %d - %f seconds'`` print (test/Dynamic_Solver.m:87,101;
    profiling.SweepTimer.on_sweep is the matching printer). Opt-in: the
    host round-trip serializes the otherwise fully-fused scan, so library
    callers stay silent and the CLI turns it on by default.
    """
    state_shape = plan.grid_shape   # == backup output shape (flat-plan safe)
    if init_values is None:
        v = jnp.zeros(plan.grid_shape, dtype=jnp.float32)
    else:
        v = jnp.asarray(init_values, dtype=jnp.float32)
    n_actions = plan.query_shape[-1]
    pdt = policy_dtype or policy_dtype_for(n_actions)
    if policy_dtype is not None and \
            np.iinfo(np.dtype(policy_dtype)).max < n_actions - 1:
        raise ValueError(
            f"policy_dtype {policy_dtype} cannot hold {n_actions} actions")
    if backup is None:
        backup = lambda v: bellman_backup(v, plan, stage_cost)  # noqa: E731

    def probe(values):
        if probe_window is None:
            return None
        starts = tuple(s for s, _ in probe_window)
        sizes = tuple(n for _, n in probe_window)
        return jax.lax.dynamic_slice(values, starts, sizes)

    def tick(i):
        if on_sweep is not None:
            jax.debug.callback(on_sweep, i)

    def sweep(v, i):
        res = backup(v)
        tick(i)
        out = res.argmin.astype(pdt) if store_policies else res.argmin
        return res.values, (out, probe(res.values))

    if not store_policies and getattr(backup, "carry_padded", False):
        # padded-carry mode (flagship 6-D envelope): the scan carry IS the
        # kernel's padded table — no per-sweep pad/slice copies, ~8 B/cell
        # less peak HBM than the plain no-store path (the 512M-cell lever)
        if probe_window is not None:
            raise ValueError("probe_window unsupported with a carry_padded "
                             "backup (the carry is the padded table)")
        adt = backup.argmin_dtype

        def sweep_carry(carry, i):
            v2p, _ = carry
            out = backup.sweep_carry(v2p)
            tick(i)
            return out, None

        a0 = jnp.zeros(backup.carry_shape, adt)
        (v2p, argm), _ = jax.lax.scan(sweep_carry, (backup.pad_carry(v), a0),
                                      jnp.arange(num_sweeps))
        # FLAT-plan results stay in the flat (rows, lanes) layout; small
        # non-flat problems keep the state shape.
        values = backup.unpad_values(v2p)
        argmin = backup.unpad_argmin(argm)
        if not narrow_argmin_result:
            # SolveResult contract is int32; envelope callers opt out —
            # the int32 OUTPUT buffer alone is 3.5 GB at 884M cells
            argmin = argmin.astype(jnp.int32)
        flat_plan = len(plan.query_shape) != plan.ndim + 1
        if not flat_plan:
            values = values.reshape(state_shape)
            argmin = argmin.reshape(state_shape)
        return SolveResult(
            values=values,
            argmin=argmin,
            policies=None,
            num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
            converged=jnp.asarray(False),
            probes=None,
        )

    if store_policies:
        values, (policies, probes) = jax.lax.scan(sweep, v,
                                                  jnp.arange(num_sweeps))
        argmin = policies[-1] if narrow_argmin_result \
            else policies[-1].astype(jnp.int32)
    else:
        # keep only the last argmin; avoid stacking. The carry holds it in
        # the NARROW policy dtype (uint8 at <=256 actions) — at envelope
        # grids the int32 double-buffered carry alone is ~2 GB of HBM.
        def sweep_last(carry, i):
            v, _ = carry
            res = backup(v)
            tick(i)
            return (res.values, res.argmin.astype(pdt)), probe(res.values)

        (values, argmin), probes = jax.lax.scan(
            sweep_last, (v, jnp.zeros(state_shape, pdt)),
            jnp.arange(num_sweeps)
        )
        # narrow_argmin_result is honored on EVERY finite path (not just
        # padded-carry): the int32 output buffer alone is multi-GB at
        # envelope grids, whichever engine mode carried the sweeps
        if not narrow_argmin_result:
            argmin = argmin.astype(jnp.int32)
        policies = None
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=policies if store_policies else None,
        num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
        converged=jnp.asarray(False),
        probes=probes,
    )


def value_iteration_converged(
    plan: InterpPlan,
    stage_cost: jax.Array,
    max_sweeps: int,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    init_values: Optional[jax.Array] = None,
    backup=None,
    on_check=None,
    narrow_argmin_result: bool = False,
) -> SolveResult:
    """Value iteration with the reference's periodic-checksum early stop.

    Mirrors pos-att/Solver_pos_att.m:268-286: iterate ``k_s`` from
    ``max_sweeps`` down to 1; whenever ``k_s % check_every == 0`` (after the
    sweep at that ``k_s``), compare ``errorF = Σ V - Σ V_prev_check`` and
    stop per :func:`convergence_stop` (``tol_mode='abs'`` is the reference
    rule ``|errorF| < tol``; ``'rel'`` the scale-free beyond-parity
    variant). Each check also records
    ``errorU = Σ argmin_ids - Σ argmin_ids_prev_check`` (the reference's
    second diagnostic, :275-278); both land in ``SolveResult.checks`` as
    rows ``[k_s, errorF, errorU]`` and — when ``on_check`` is given — are
    streamed to the host per check via ``jax.debug.callback`` with signature
    ``on_check(k_s, errorF, errorU)`` (the reference's
    'stage %d ... errorF %f - errorU %f' print).

    ``narrow_argmin_result``: as in :func:`value_iteration_finite` — return
    the argmin in the narrow policy dtype instead of int32, so
    envelope-scale CONVERGED solves skip the multi-GB int32 output buffer
    too (symmetry with the finite driver).
    """
    state_shape = plan.grid_shape   # == backup output shape (flat-plan safe)
    if init_values is None:
        v = jnp.zeros(plan.grid_shape, dtype=jnp.float32)
    else:
        v = jnp.asarray(init_values, dtype=jnp.float32)

    if backup is None:
        backup = lambda v: bellman_backup(v, plan, stage_cost)  # noqa: E731
    # backups may emit argmin in a narrow dtype (uint8 at <= 256 actions —
    # the 6-D kernel's envelope mode); the while_loop carry must match
    adt = getattr(backup, "argmin_dtype", None) or jnp.int32

    n_checks = max(max_sweeps // check_every, 1)

    # one while_loop serves BOTH engine modes; only the sweep call, the
    # checksum extraction, and the init/finalize differ (keeping the stop
    # rule, check recording, and carry layout literally shared — they
    # drifted apart once as hand-maintained copies)
    def run_loop(sweep, fsum_of, usum_of, v0, a0):
        def cond(carry):
            k_s, converged = carry[2], carry[4]
            return jnp.logical_and(k_s >= 1, jnp.logical_not(converged))

        def body(carry):
            vc, ac, k_s, (fsum_prev, usum_prev), _, checks, c_idx = carry
            v2, argm = sweep(vc, ac)
            do_check = (k_s % check_every) == 0
            fsum = fsum_of(v2)
            usum = usum_of(argm)
            err_f = fsum - fsum_prev
            err_u = usum - usum_prev
            converged = jnp.logical_and(
                do_check, convergence_stop(err_f, fsum, tol, tol_mode))

            def record(args):
                checks, c_idx = args
                row = jnp.stack([k_s.astype(jnp.float32), err_f, err_u])
                if on_check is not None:
                    jax.debug.callback(on_check, k_s, err_f, err_u)
                return checks.at[c_idx].set(row), c_idx + 1

            checks, c_idx = jax.lax.cond(do_check, record,
                                         lambda args: args, (checks, c_idx))
            fsum_prev = jnp.where(do_check, fsum, fsum_prev)
            usum_prev = jnp.where(do_check, usum, usum_prev)
            return (v2, argm, k_s - 1, (fsum_prev, usum_prev), converged,
                    checks, c_idx)

        init = (
            v0,
            a0,
            jnp.asarray(max_sweeps, jnp.int32),
            (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32)),
            jnp.asarray(False),
            jnp.zeros((n_checks, 3), jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        vf, af, k_s, _, converged, checks, _ = jax.lax.while_loop(
            cond, body, init)
        return vf, af, k_s, converged, checks

    pdt = (policy_dtype_for(plan.query_shape[-1]) if narrow_argmin_result
           else jnp.int32)
    if getattr(backup, "carry_padded", False):
        # padded-carry mode (see value_iteration_finite): the while_loop
        # carry is the kernel's padded table. Checksums slice out the real
        # (NW, NE) block so the reference's errorF/errorU stop rule sums
        # exactly the plain path's cells.
        real_block = backup.unpad_values

        v2p, argm, k_s, converged, checks = run_loop(
            lambda vc, ac: backup.sweep_carry(vc),
            lambda v2: jnp.sum(real_block(v2), dtype=jnp.float32),
            lambda a2: jnp.sum(real_block(a2).astype(jnp.float32),
                               dtype=jnp.float32),
            backup.pad_carry(v),
            jnp.zeros(backup.carry_shape, adt))
        values = backup.unpad_values(v2p)
        argmin = backup.unpad_argmin(argm).astype(pdt)
        if len(plan.query_shape) == plan.ndim + 1:   # non-flat plan
            values = values.reshape(state_shape)
            argmin = argmin.reshape(state_shape)
    else:
        def plain_sweep(vc, ac):
            res = backup(vc)
            return res.values, res.argmin

        values, argmin, k_s, converged, checks = run_loop(
            plain_sweep,
            lambda v2: jnp.sum(v2, dtype=jnp.float32),
            lambda a2: jnp.sum(a2, dtype=jnp.float32),
            v,
            jnp.zeros(state_shape, adt))
        argmin = argmin.astype(pdt)

    return SolveResult(
        values=values,
        argmin=argmin,
        policies=None,
        num_sweeps=jnp.asarray(max_sweeps, jnp.int32) - k_s,
        converged=converged,
        checks=checks,
    )


def value_iteration_segmented(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    *,
    segment_size: int = 100,
    init_values: Optional[jax.Array] = None,
    start_sweep: int = 0,
    backup=None,
    store_policies: bool = False,
    policy_dtype=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_axes=None,
    on_segment=None,
    narrow_argmin_result: bool = False,
    tol: Optional[float] = None,
    tol_mode: str = "abs",
) -> SolveResult:
    """Finite-horizon solve in host-visible segments.

    Runs ``segment_size`` sweeps per jitted call (one compilation, reused),
    returning control to the host between segments. This provides three
    capabilities the reference lacks and that big solves need
    (SURVEY.md §5 checkpoint/resume; §7 per-stage policy storage):

    * **policy streaming**: with ``store_policies``, each segment's per-sweep
      policy tables are fetched to HOST memory immediately, so device HBM
      only ever holds one segment of tables (Dynamic_Solver stores all
      N per-stage tables; on-device that limits grid x horizon).
    * **mid-solve checkpointing**: with ``checkpoint_path``, the value table
      and sweep index are written (``io.save_values``) after every segment.
    * **resume**: pass ``init_values``/``start_sweep`` from
      ``io.load_values`` to continue an interrupted solve.

    ``on_segment(sweep_index, values)`` is an optional host callback (e.g.
    progress logging — the reference prints per-stage timings,
    Dynamic_Solver.m:87,101).

    Padded-carry backups (the flagship 6-D envelope mode) are supported:
    each segment runs :func:`value_iteration_finite`'s padded-carry scan,
    checkpoints hold the FLAT (rows, lanes) value table, and resumed
    segments re-pad it (pads are zeros at every segment start AND after
    every in-kernel sweep, and real cells never read pad lanes — per-axis
    tap clamping — so the segmented solve is BITWISE the uninterrupted
    one; tests/test_segmented.py pins this). ``store_policies`` is
    incompatible with that mode; intermediate segments always return their
    argmin in the narrow kernel dtype, ``narrow_argmin_result`` governing
    only the final result (the multi-GB int32 widening happens at most
    once, if at all).

    ``tol``: optional EARLY STOP — the converged engine's periodic
    checksum rule (:func:`convergence_stop`, abs or ``tol_mode='rel'``)
    evaluated host-side at each segment boundary, with ``segment_size``
    playing the reference's ``check_every`` cadence. This is how the
    nominal multi-hour envelope solve runs: checkpoint + convergence
    check at the same boundary, one scalar fetch per segment (the value
    checksum over real cells — pad lanes are zeros in every flat/padded
    layout, so a plain sum is the masked sum). Mirrors the reference's
    in-loop stop (Solver_pos_att.m:268-286) at segment granularity:
    with ``segment_size == check_every`` and the same horizon the stop
    DECISION is identical (the checksums are the same sums, fetched
    rather than while_loop-carried).

    Returns a SolveResult whose ``policies`` (if stored) is a HOST numpy
    array of shape (num_sweeps - start_sweep, *state_shape).
    """
    state_shape = plan.grid_shape   # == backup output shape (flat-plan safe)
    n_actions = plan.query_shape[-1]
    pdt = policy_dtype or policy_dtype_for(n_actions)
    if policy_dtype is not None and \
            np.iinfo(np.dtype(policy_dtype)).max < n_actions - 1:
        raise ValueError(
            f"policy_dtype {policy_dtype} cannot hold {n_actions} actions")
    carry_padded = getattr(backup, "carry_padded", False)
    if carry_padded and store_policies:
        raise ValueError(
            "store_policies is unsupported with a carry_padded backup "
            "(per-sweep policy stacks defeat the envelope memory budget)")
    if init_values is None:
        v = jnp.zeros(plan.grid_shape, dtype=jnp.float32)
    else:
        v = jnp.asarray(init_values, dtype=jnp.float32)

    from functools import partial

    @partial(jax.jit, static_argnames=("n", "store", "narrow"))
    def run_segment(v, n, store, narrow):
        return value_iteration_finite(
            plan, stage_cost, n, init_values=v, store_policies=store,
            policy_dtype=pdt, backup=backup, narrow_argmin_result=narrow,
        )

    if tol is not None and tol_mode not in ("abs", "rel"):
        raise ValueError(f"unknown tol_mode {tol_mode!r}; use 'abs' or 'rel'")
    host_policies = [] if store_policies else None
    sweep = start_sweep
    argmin = None
    prev_f = 0.0       # the converged engine's init (first err = full sum)
    converged = False
    while sweep < num_sweeps:
        if tol is not None:
            # align segment boundaries to the converged engine's check
            # sweeps (its countdown checks at sweeps == (num_sweeps+1)
            # mod check_every) so the stop decision — and therefore the
            # stopped-at values — are IDENTICAL, not one-sweep-shifted
            r = (num_sweeps % segment_size + 1) % segment_size
            n = min(((r - sweep - 1) % segment_size) + 1,
                    num_sweeps - sweep)
        else:
            n = min(segment_size, num_sweeps - sweep)
        last = sweep + n >= num_sweeps
        narrow = narrow_argmin_result if last else carry_padded
        res = run_segment(v, n, store_policies, narrow)
        v = res.values
        argmin = res.argmin
        if store_policies:
            host_policies.append(np.asarray(res.policies))  # device -> host
        sweep += n
        if checkpoint_path is not None:
            from .io import save_values

            save_values(checkpoint_path, v, sweep,
                        checkpoint_axes if checkpoint_axes is not None else ())
        if on_segment is not None:
            on_segment(sweep, v)
        if tol is not None:
            fsum = float(jnp.sum(v, dtype=jnp.float32))
            if bool(convergence_stop(jnp.float32(fsum - prev_f),
                                     jnp.float32(fsum), tol, tol_mode)):
                converged = True
                break
            prev_f = fsum

    policies = np.concatenate(host_policies, axis=0) if store_policies else None
    if not narrow_argmin_result and argmin is not None:
        argmin = argmin.astype(jnp.int32)   # early stop can skip the
    return SolveResult(                     # last-segment widening
        values=v,
        argmin=argmin,
        policies=policies,
        num_sweeps=jnp.asarray(sweep - start_sweep, jnp.int32),
        converged=jnp.asarray(converged),
    )
