"""Device-resident Gauss-Newton driver.

`run_gn_loop` (solver/schur.py) reads two scalars back from the device
every iteration (the correction L1 and the LM merit values), which costs
one host round trip per GN step, and the host has nothing to decide
per-iteration that the device cannot decide itself.  Whether that round
trip matters on a locally attached GPU is yet to be measured.

This module runs the SAME algorithm — deferred trust-region LM
validation (gain-ratio accept/reject with Nielsen's lambda schedule),
Eisenstat-Walker adaptive CG forcing, convergence on the reference's
L1-of-correction contract (/root/reference/main.m:412,487-493) plus the
plateau stop, the iteration cap, and both divergence detectors —
entirely inside one `lax.while_loop`, syncing to the host once per
`chunk` iterations instead of once per iteration.  Per-iteration events
(accepted / rejected trials with their delta, lambda, forcing tol) are
written into a fixed record buffer on device and replayed to the host
after each chunk, so progress callbacks, delta_history, and
checkpointing behave as before (checkpoints land on chunk boundaries).

The host loop remains the reference implementation; `tests/
test_device_loop.py` pins step-for-step parity (same iterates, same
accept/reject sequence, same stopping reason) against it.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from fish_eye_bundle_adjustment_tpu.utils import checkpoint as ckpt_mod
from fish_eye_bundle_adjustment_tpu.utils.observe import (
    IterationRecord,
    SolverDivergence,
    Stopwatch,
)

# status codes carried on device
RUNNING = 0
CONV_THRESHOLD = 1
CONV_PLATEAU = 2
STOP_CAP = 3
DIVERGED = 4

# record kinds
REC_UNUSED = 0
REC_ACCEPT = 1
REC_REJECT = 2

_STOPPED_ON = {CONV_THRESHOLD: "threshold", CONV_PLATEAU: "plateau",
               STOP_CAP: "cap"}


def _make_chunk_fn(raw_step, opts, settings, dtype, chunk: int):
    """Build the jittable chunk function: up to `chunk` GN steps under
    one lax.while_loop.  Scalar state lives in the solver dtype — the
    same values the host loop reads back and rounds through `float()`."""
    sdt = jnp.dtype(dtype)
    thr = float(settings.threshold)
    cap = int(settings.iteration_cap)
    adaptive = bool(opts.adaptive_damping)
    forcing = bool(opts.adaptive_forcing)
    fmax = float(opts.forcing_max)
    tolmin = float(opts.cg_tol)
    kick = float(opts.damping_kick)
    max_damping = float(opts.max_damping)
    plateau = bool(opts.plateau_detection)
    slack_rel = float(np.finfo(np.dtype(dtype)).eps) ** (2.0 / 3.0)
    nrec = 2 * chunk + 2

    def write_rec(recs, ri, do, kind, count, delta, lam, cg_tol):
        """Masked record write: the row lands at the cursor either way
        (kind=UNUSED when masked — overwritten by the next real event or
        left as the terminator), the cursor advances only on real
        events.  Branch-free on purpose: lax.cond around state updates
        can copy the big v/x buffers at every conditional boundary;
        where-merges cost ~the buffer bandwidth instead."""
        row = jnp.stack([
            jnp.where(do, jnp.asarray(kind, sdt), REC_UNUSED),
            jnp.asarray(count, jnp.int32).astype(sdt),
            jnp.asarray(delta, sdt),
            jnp.asarray(lam, sdt),
            jnp.asarray(cg_tol, sdt),
        ])
        zero = jnp.asarray(0, ri.dtype)
        recs = lax.dynamic_update_slice(recs, row[None, :], (ri, zero))
        return recs, ri + do.astype(ri.dtype)

    def apply_accept(st, recs, ri, do):
        """accept_pending() as a where-merge: when `do` the pending
        trial becomes the iterate (count, forcing tol, plateau buffer,
        stopping checks all advance); otherwise state passes through.
        Mirrors run_gn_loop — convergence/cap/divergence checks run at
        acceptance time only."""
        delta = st["pend_delta"]
        count1 = st["count"] + 1
        # non-adaptive divergence detector (check_divergence): NaN/Inf
        # or a 1e6x blow-up over the best previous correction
        finite = jnp.isfinite(delta)
        blew_up = finite & (delta > 1e6 * st["run_min"])
        diverged = jnp.logical_and(
            not adaptive, jnp.logical_or(~finite, blew_up)
        ) & do
        run_min = jnp.where(
            do & finite, jnp.minimum(st["run_min"], delta), st["run_min"]
        )
        # Eisenstat-Walker forcing from relative progress
        delta0_new = jnp.where(
            st["delta0"] > 0, st["delta0"], jnp.maximum(delta, 1e-30)
        )
        delta0 = jnp.where(do, delta0_new, st["delta0"])
        rel = delta / delta0_new
        cg_tol = (
            jnp.where(
                do, jnp.clip(rel * rel, tolmin, fmax), st["cg_tol"]
            ).astype(sdt)
            if forcing else st["cg_tol"]
        )
        dbuf_new = jnp.concatenate(
            [st["dbuf"][1:], delta[None].astype(sdt)]
        )
        dbuf = jnp.where(do, dbuf_new, st["dbuf"])
        recs, ri = write_rec(
            recs, ri, do, REC_ACCEPT, count1, delta, st["lam"], cg_tol
        )
        # stopping decisions (at acceptance, as in accept_pending)
        lam_low = st["lam"] <= 1e-3
        conv_thr = (delta <= thr) & jnp.logical_or(not adaptive, lam_low)
        last5, prev5 = dbuf_new[5:], dbuf_new[:5]
        m_last = jnp.mean(last5)
        m_prev = jnp.mean(prev5)
        flat = (jnp.max(last5) - jnp.min(last5)) <= 0.02 * jnp.abs(m_last)
        improving = m_last < 0.98 * m_prev
        conv_plat = jnp.logical_and(
            plateau,
            (count1 >= 10) & lam_low & flat & ~improving
            & jnp.all(jnp.isfinite(dbuf_new)),
        )
        status_acc = jnp.where(
            diverged, DIVERGED,
            jnp.where(
                conv_thr, CONV_THRESHOLD,
                jnp.where(
                    conv_plat, CONV_PLATEAU,
                    jnp.where(count1 >= cap, STOP_CAP, RUNNING),
                ),
            ),
        ).astype(jnp.int32)
        st = dict(
            st,
            x=jnp.where(do, st["pend_x"], st["x"]),
            v=jnp.where(do, st["pend_v"], st["v"]),
            stats=jnp.where(do, st["pend_stats"], st["stats"]),
            count=jnp.where(do, count1, st["count"]),
            run_min=run_min, delta0=delta0, cg_tol=cg_tol, dbuf=dbuf,
            status=jnp.where(do, status_acc, st["status"]).astype(
                jnp.int32
            ),
            have_pend=st["have_pend"] & ~do,
        )
        return st, recs, ri

    @jax.jit
    def chunk_fn(st, obs):
        def body(carry):
            st, recs, ri, k = carry
            x_in = jnp.where(st["have_pend"], st["pend_x"], st["x"])
            x_trial, dsum, v_trial, stats_t, _ = raw_step(
                x_in, obs, st["cg_tol"], st["lam"]
            )
            cost_here = stats_t[3]
            rejected = jnp.asarray(False)
            if adaptive:
                # validate the pending trial against the true cost its
                # point shows (this step's cost_old)
                validating = st["have_pend"]
                actual = st["pend_cost"] - cost_here
                pred = st["pend_cost"] - st["pend_model"]
                slack = slack_rel * jnp.maximum(st["pend_cost"], 1.0)
                finite = (
                    jnp.isfinite(cost_here) & jnp.isfinite(st["pend_delta"])
                )
                tiny = finite & (st["pend_delta"] <= thr)
                ok = tiny | (finite & (actual >= -slack))
                rejected = validating & ~ok
                # Nielsen schedule on acceptance; raise-and-double on
                # rejection
                rho = jnp.where(pred > slack, actual / pred, 1.0)
                lam_acc = st["lam"] * jnp.maximum(
                    1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
                )
                lam_acc = jnp.where(lam_acc < 1e-14, 0.0, lam_acc)
                lam_rej = jnp.maximum(st["lam"] * st["nu"], kick)
                nu_rej = jnp.minimum(st["nu"] * 2.0, 64.0)
                lam = jnp.where(
                    rejected, lam_rej,
                    jnp.where(validating, lam_acc, st["lam"]),
                ).astype(sdt)
                nu = jnp.where(
                    rejected, nu_rej,
                    jnp.where(validating, jnp.asarray(2.0, sdt), st["nu"]),
                ).astype(sdt)
                diverged = rejected & (lam > max_damping)
                recs, ri = write_rec(
                    recs, ri, rejected, REC_REJECT, st["count"],
                    st["pend_delta"], lam, st["cg_tol"],
                )
                st = dict(
                    st, lam=lam, nu=nu,
                    status=jnp.where(
                        diverged, DIVERGED, st["status"]
                    ).astype(jnp.int32),
                    # a rejection discards the pending trial AND this
                    # step's outputs (computed from the bad trial point)
                    have_pend=st["have_pend"] & ~rejected,
                )

            # the surviving pending trial becomes the iterate
            st, recs, ri = apply_accept(
                st, recs, ri, st["have_pend"] & (st["status"] == RUNNING)
            )

            # stage this step's trial as the new pending iterate
            stage = (st["status"] == RUNNING) & ~rejected
            st = dict(
                st,
                pend_x=jnp.where(stage, x_trial, st["pend_x"]),
                pend_cost=jnp.where(stage, cost_here, st["pend_cost"]),
                pend_model=jnp.where(stage, stats_t[0], st["pend_model"]),
                pend_delta=jnp.where(stage, dsum, st["pend_delta"]),
                pend_v=jnp.where(stage, v_trial, st["pend_v"]),
                pend_stats=jnp.where(stage, stats_t, st["pend_stats"]),
                have_pend=st["have_pend"] | stage,
            )
            # immediate acceptance: pure-GN mode always, or a tiny trial
            # (at the fixed point damped and undamped corrections
            # coincide)
            if adaptive:
                immediate = stage & jnp.isfinite(dsum) & (dsum <= thr)
            else:
                immediate = stage
            st, recs, ri = apply_accept(st, recs, ri, immediate)
            return st, recs, ri, k + 1

        def cond(carry):
            st, _, ri, k = carry
            # each body iteration writes at most 2 records; nrec bounds
            # the buffer even when rejections double the event rate
            return (
                (st["status"] == RUNNING) & (k < chunk) & (ri < nrec - 1)
            )

        recs = jnp.zeros((nrec, 5), sdt)
        ri = jnp.asarray(0, jnp.int32)
        st, recs, _, _ = lax.while_loop(
            cond, body, (st, recs, ri, jnp.asarray(0, jnp.int32))
        )
        # pack EVERYTHING the host reads per chunk into one array: each
        # separate device->host read is a round trip of its own, so
        # recs/status/count arrive together
        packed = jnp.concatenate([
            recs.reshape(-1).astype(jnp.float32),
            st["status"].astype(jnp.float32)[None],
            st["count"].astype(jnp.float32)[None],
            st["pend_delta"].astype(jnp.float32)[None],
        ])
        return st, packed

    return chunk_fn


def run_gn_loop_device(
    raw_step, obs, layout, problem, opts, x0=None, progress_fn=None,
    checkpoint_path=None, checkpoint_every: int = 1, chunk: int = 16,
    chunk_fn=None, n_pad: Optional[int] = None,
):
    """Drop-in replacement for run_gn_loop running `chunk` GN iterations
    per host round trip.  Same return tuple:
    (x, history, delta_history, v_local, stats, count, converged,
    elapsed, stopped_on).  keep_history is not supported (solve_schur
    falls back to the host loop for trajectory plots).

    `chunk_fn` injects a prebuilt (already traced/compiled) chunk
    function from _make_chunk_fn — each call here otherwise builds a
    fresh jit closure, so repeated solves of the same shapes (benchmarks,
    posegraph partitions) would recompile.  `n_pad` overrides the
    residual-row count for the v buffers (global padded rows for the
    distributed steps whose data pytree is not row-major ObsData)."""
    settings = problem.settings
    dtype = opts.dtype
    sdt = jnp.dtype(dtype)
    t0 = time.perf_counter()
    x = jnp.asarray(
        (layout.initial() if x0 is None else np.asarray(x0)).astype(dtype)
    )
    delta_history: list = []
    count = 0
    cg_tol0 = opts.forcing_max if opts.adaptive_forcing else opts.cg_tol
    delta0 = 0.0
    if checkpoint_path is not None:
        resumed = ckpt_mod.load_checkpoint(checkpoint_path, problem)
        if resumed is not None:
            x = jnp.asarray(resumed.x.astype(dtype))
            count = resumed.iteration
            delta_history = list(resumed.delta_history)
            if delta_history:
                delta0 = max(delta_history[0], 1e-300)
                rel = delta_history[-1] / delta0
                cg_tol0 = max(
                    opts.cg_tol, min(opts.forcing_max, rel * rel)
                )
    watch = Stopwatch()

    if n_pad is None:
        n_pad = obs.W.shape[0]
    dbuf0 = np.full(10, np.inf, np.dtype(dtype))
    if delta_history:
        tail = delta_history[-10:]
        dbuf0[10 - len(tail):] = tail
    finite_hist = [d for d in delta_history if np.isfinite(d)]
    st = dict(
        x=x,
        v=jnp.zeros((n_pad, 2), sdt),
        stats=jnp.zeros(4, sdt),
        count=jnp.asarray(count, jnp.int32),
        status=jnp.asarray(RUNNING, jnp.int32),
        have_pend=jnp.asarray(False),
        pend_x=x,
        pend_cost=jnp.asarray(0.0, sdt),
        pend_model=jnp.asarray(0.0, sdt),
        pend_delta=jnp.asarray(0.0, sdt),
        pend_v=jnp.zeros((n_pad, 2), sdt),
        pend_stats=jnp.zeros(4, sdt),
        lam=jnp.asarray(opts.init_damping, sdt),
        nu=jnp.asarray(2.0, sdt),
        cg_tol=jnp.asarray(cg_tol0, sdt),
        delta0=jnp.asarray(delta0, sdt),
        run_min=jnp.asarray(
            min(finite_hist) if finite_hist else np.inf, sdt
        ),
        dbuf=jnp.asarray(dbuf0),
    )
    if chunk_fn is None:
        chunk_fn = _make_chunk_fn(raw_step, opts, settings, dtype, chunk)

    nrec = 2 * chunk + 2
    status = RUNNING
    # Speculative pipelining: the NEXT chunk is enqueued before this
    # chunk's packed result is read, so the device->host round trip
    # hides behind device execution.  A chunk launched on a finished
    # state is free — its while-cond sees status != RUNNING and exits
    # without running a single step — so over-speculation costs nothing.
    st, packed = chunk_fn(st, obs)
    while True:
        st_next, packed_next = chunk_fn(st, obs)  # speculative
        arr = np.asarray(packed, np.float64)  # ONE host sync per chunk
        recs = arr[: nrec * 5].reshape(nrec, 5)
        status = int(arr[-3])
        lap = watch.lap()
        n_events = int(np.sum(recs[:, 0] != REC_UNUSED))
        n_accepts = int(np.sum(recs[:, 0] == REC_ACCEPT))
        per = lap / max(n_events, 1)
        for kind, cnt, delta, lam, ctol in recs:
            if kind == REC_UNUSED:
                break
            if kind == REC_ACCEPT:
                delta_history.append(float(delta))
                if progress_fn is not None:
                    progress_fn(IterationRecord(
                        int(cnt), float(delta), per, float(ctol),
                        damping=float(lam),
                    ))
            elif progress_fn is not None:
                progress_fn(IterationRecord(
                    int(cnt), float(delta), per, float(ctol),
                    accepted=False, damping=float(lam),
                ))
        count = int(arr[-2])
        if status == DIVERGED:
            bad = float(recs[n_events - 1][2]) if n_events else float(arr[-1])
            raise SolverDivergence(count + 1, bad, delta_history)
        if checkpoint_path is not None and n_accepts and (
            count // checkpoint_every
            > (count - n_accepts) // checkpoint_every
        ):
            ckpt_mod.save_checkpoint(
                checkpoint_path,
                ckpt_mod.SolverCheckpoint(
                    x=np.asarray(st["x"]), iteration=count,
                    delta_history=delta_history,
                    meta={k: str(v) for k, v in
                          ckpt_mod.problem_fingerprint(problem).items()},
                ),
            )
        if status != RUNNING:
            # st is the terminal state; the speculative chunk was a
            # no-op pass-through of it
            break
        st, packed = st_next, packed_next

    elapsed = time.perf_counter() - t0
    converged = status in (CONV_THRESHOLD, CONV_PLATEAU)
    stopped_on = _STOPPED_ON.get(status, "cap")
    return (
        st["x"], [], delta_history, st["v"], st["stats"], count,
        converged, elapsed, stopped_on,
    )
