"""Tie-axis (point-state) sharding (parallel/tieshard.py + sharded_state
point_mode='sharded') vs the single-device solver: same solution, with
per-device point arrays ~ n_tie/N and O(N)-word boundary exchanges
(SURVEY §2.5 row 2)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh  # noqa: E402
from fish_eye_bundle_adjustment_tpu.parallel.sharded_state import (  # noqa: E402
    solve_schur_sharded_state,
)
from fish_eye_bundle_adjustment_tpu.parallel.tieshard import (  # noqa: E402
    build_tie_shard,
)
from fish_eye_bundle_adjustment_tpu.solver.schur import (  # noqa: E402
    SchurOptions,
    solve_schur,
)
from fish_eye_bundle_adjustment_tpu.synth import make_block  # noqa: E402


def test_plan_geometry():
    """Owned ranges tile [0, n_tie); boundary list is O(N); local spans
    are ~ n_tie/N."""
    rng = np.random.default_rng(0)
    n_tie, N = 997, 8
    counts = rng.integers(1, 12, n_tie)
    ids = np.repeat(np.arange(n_tie), counts)
    pad = (-ids.size) % N
    ids = np.concatenate([ids, np.full(pad, n_tie)])
    ts = build_tie_shard(ids, n_tie, N)
    own = np.asarray(ts.own_n).reshape(-1)
    assert own.sum() == n_tie
    assert ts.Bp <= N  # <= N-1 boundary ties (Bp >= 1 padding)
    assert ts.L <= 2 * n_tie // N + 2  # local span ~ n_tie/N

    # every tie is mapped to exactly one (owner, position)
    owner = np.asarray(ts.owner_of_tie)
    pos = np.asarray(ts.pos_in_owner)
    seen = set(zip(owner.tolist(), pos.tolist()))
    assert len(seen) == n_tie
    assert pos.max() < ts.max_own


@pytest.mark.parametrize("ic", [False, True])
def test_tie_sharded_matches_single_device(ic):
    blk = make_block(
        n_img=16, n_pts=300, model="fisheye", seed=21,
        settings_overrides={"inner_constraints": ic},
        control_frac=0.0 if ic else 0.05,
    )
    p = blk.problem
    opts = SchurOptions(dtype=np.float64)
    r1 = solve_schur(p, opts, keep_history=False, compute_covariance=False)
    rt = solve_schur_sharded_state(
        p, make_mesh(8), opts, keep_history=False, point_mode="sharded"
    )
    assert rt.converged == r1.converged
    np.testing.assert_allclose(rt.x, r1.x, rtol=1e-8, atol=1e-8)
    assert abs(rt.sigma02 - r1.sigma02) < 1e-8


@pytest.mark.slow
def test_tie_sharded_selfcal():
    blk = make_block(
        n_img=24, n_pts=500, model="fisheye", seed=23,
        settings_overrides={
            "inner_constraints": False, "estimate_c": True,
            "estimate_xp": True, "estimate_yp": True,
            "estimate_radial": True, "estimate_decent": True,
        },
        control_frac=0.05,
    )
    p = blk.problem
    opts = SchurOptions(dtype=np.float64)
    r1 = solve_schur(p, opts, keep_history=False, compute_covariance=False)
    rt = solve_schur_sharded_state(
        p, make_mesh(4), opts, keep_history=False, point_mode="sharded"
    )
    np.testing.assert_allclose(rt.x, r1.x, rtol=1e-7, atol=1e-7)


def test_zero_observation_tie_at_boundary():
    """A tie with zero observations whose searchsorted start lands at a
    shard boundary must not shift the owner's slot positions (r4 advisor
    finding: own_lo went negative and dynamic_slice clamping silently
    corrupted EVERY owned point correction on that shard).  Zero-obs ties
    route to the virtual zero plane; interior zero-obs holes keep later
    ties' slot positions intact."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from fish_eye_bundle_adjustment_tpu.parallel.tieshard import (
        LocalTieOps,
        pspec,
    )

    cases = [
        # advisor repro: tie 2 unobserved, start lands exactly at the
        # shard boundary (owner would have been shard 1, span [3,4])
        (np.array([0, 0, 0, 1, 3, 3, 4, 4]), 5, 2),
        # interior hole: tie 1 unobserved inside shard 0's owned range
        (np.array([0, 0, 2, 2, 3, 3, 4, 4]), 5, 2),
        # two consecutive unobserved ties straddling a boundary
        (np.array([0, 0, 0, 0, 1, 4, 4, 5]), 6, 2),
    ]
    for ids, n_tie, N in cases:
        ts_host = build_tie_shard(ids.astype(np.int64), n_tie, N)
        assert int(np.asarray(ts_host.own_lo).min()) >= 0
        mesh = make_mesh(N)
        ts = jax.tree.map(
            lambda a, s: jax.device_put(
                a, jax.sharding.NamedSharding(mesh, s)),
            ts_host, pspec("obs", ts_host),
        )
        L = ts_host.L

        m = ids.size // N
        gid = jnp.asarray(ids.reshape(N, m).astype(np.int32))
        gid = jax.device_put(
            gid, jax.sharding.NamedSharding(mesh, P("obs")))

        def body(ts_l, gid_l):
            lops = LocalTieOps(ts_l, "obs")
            g = gid_l[0]  # (m,) this shard's global ids
            # local slot s of this shard holds the GLOBAL id lo + s:
            # reconstruct lo as min live global id of the slice
            lo = jnp.min(jnp.where(lops.tie_local < L, g, n_tie))
            local_vals = (
                lo + jnp.arange(L, dtype=jnp.int32)
            ).astype(jnp.float64)[:, None] * jnp.ones((1, 3))
            return lops.gather_global(local_vals)

        out = jax.jit(
            shard_map(
                body, mesh=mesh,
                in_specs=(pspec("obs", ts_host), P("obs")), out_specs=P(),
                check_vma=False,
            )
        )(ts, gid)
        out = np.asarray(out)
        observed = np.isin(np.arange(n_tie), ids)
        for t in range(n_tie):
            want = float(t) if observed[t] else 0.0
            np.testing.assert_allclose(out[t], want, err_msg=f"{ids} tie {t}")
