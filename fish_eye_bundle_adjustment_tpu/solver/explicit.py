"""Explicitly materialized reduced camera system (dense S) — the
small-problem single-device path.

The matrix-free Schur matvec re-pays its per-row gathers and segment
sums on every CG iteration.  This module pays the per-row cost ONCE per
Gauss-Newton step to materialize the reduced camera system

    S = Hcc - Hcp Hpp^-1 Hpc          (nc x nc, nc = 6 n_img + n_cam ni)

as a dense matrix, after which every CG matvec is a dense GEMV (~144 MB
read at 1k images in f32, bandwidth bound) and the Schur-Jacobi
preconditioner falls out of S's diagonal for free.

The coupling term is a sum over observation PAIRS sharing a tie point
(each (image, point) pair has exactly one observation, reference
BuildAwG.m:46 row structure):

    S_corr[ia, ib] += Mt_a @ Mt_b',   Mt_o = (Je' W Jp)_o @ chol(Hpp^-1)

Pair enumeration is STATIC (host, once per problem; see PairPlan): the
unordered cross pairs (a < b) are pre-sorted by flat block key
ia * n_img + ib (ia <= ib after swap) so the on-device reduction is two
row gathers + one batched 6x3 @ 3x6 product + one sorted segment sum into
the flat (n_img^2, 36) block table.  Self pairs (a == b) reduce with the
existing image-axis plan.  Everything else (rhs, back-substitution,
residual stats) reuses the matrix-free SchurFactors streams.

Layout note: every large array here is kept strictly 2-D with the small
block dimension FLATTENED into columns — flat (P, 36) columns with
unrolled index arithmetic instead of rank-3 (P, 6, 6) blocks, whose small
trailing dimensions pad badly under tiled layouts.

Applicability: dense S costs 36 n_img^2 floats — 144 MB (f32) at 1k
images, ~2.3 GB at 4k.  ``solve_schur`` auto-selects this path below
``SchurOptions.explicit_s_max_images`` and falls back to the matrix-free
matvec beyond it (the distributed/sharded paths always stay matrix-free).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fish_eye_bundle_adjustment_tpu.ops.segment import (
    SegmentLayout,
    sorted_segment_sum,
)


def _chol3x3_flat(H9):
    """Batched closed-form lower Cholesky, flat (m, 9) -> flat (m, 9).

    Input rows are row-major 3x3 SPD matrices; output rows are row-major
    lower-triangular factors L with L L' = H."""
    a = jnp.sqrt(H9[:, 0])
    b = H9[:, 3] / a
    c = H9[:, 6] / a
    d = jnp.sqrt(H9[:, 4] - b * b)
    e = (H9[:, 7] - c * b) / d
    f = jnp.sqrt(H9[:, 8] - c * c - e * e)
    z = jnp.zeros_like(a)
    return jnp.stack([a, z, z, b, d, z, c, e, f], axis=1)


def _flat_abt(A, B, m, n, k):
    """C = A @ B' rowwise on flat blocks: (r, m*k) x (r, n*k) -> (r, m*n),
    C[:, i*n+j] = sum_q A[:, i*k+q] * B[:, j*k+q]."""
    cols = [
        sum(A[:, i * k + q] * B[:, j * k + q] for q in range(k))
        for i in range(m)
        for j in range(n)
    ]
    return jnp.stack(cols, axis=1)


def _flat_ab(A, B, m, k, n):
    """C = A @ B rowwise on flat blocks: (r, m*k) x (r, k*n) -> (r, m*n)."""
    cols = [
        sum(A[:, i * k + q] * B[:, q * n + j] for q in range(k))
        for i in range(m)
        for j in range(n)
    ]
    return jnp.stack(cols, axis=1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PairPlan:
    """Static observation-pair structure for the explicit S_corr build.

    pa/pb index rows of the tie-sorted observation stream; pairs are
    sorted by flat block key ia * n_img + ib with ia <= ib, so the
    on-device reduction into the (n_img^2,) block table is a sorted
    segment sum (no scatter)."""

    pa: jax.Array  # (P,) int32 observation row of the first pair member
    pb: jax.Array  # (P,) int32 second member; img[pa] <= img[pb]
    key_begs: jax.Array  # (n_img^2,) int32 segment offsets into the pair
    key_ends: jax.Array  # stream (SegmentLayout rows over block keys)

    @staticmethod
    def build(tie_sorted: np.ndarray, img: np.ndarray, n_tie: int,
              n_img: int) -> "PairPlan":
        """Host-side enumeration of unordered cross pairs (a < b) of
        observations sharing a live tie, normalized and sorted by block
        key.  `tie_sorted` must be sorted ascending with control/padding
        rows carrying id >= n_tie."""
        n_live = int(np.searchsorted(tie_sorted, n_tie))
        ids = tie_sorted[:n_live]
        starts = np.searchsorted(ids, np.arange(n_tie + 1)).astype(np.int64)
        counts = np.diff(starts)
        # all ordered pairs (a, b) within a segment, then keep a < b
        seg_pairs = counts**2
        P_full = int(seg_pairs.sum())
        pair_seg = np.repeat(np.arange(n_tie), seg_pairs)
        offs = np.concatenate([[0], np.cumsum(seg_pairs)])
        within = np.arange(P_full) - np.repeat(offs[:-1], seg_pairs)
        k = counts[pair_seg]
        pa = starts[pair_seg] + within // np.maximum(k, 1)
        pb = starts[pair_seg] + within % np.maximum(k, 1)
        lt = pa < pb
        pa, pb = pa[lt], pb[lt]
        ia, ib = img[pa].astype(np.int64), img[pb].astype(np.int64)
        swap = ia > ib
        pa2 = np.where(swap, pb, pa)
        pb2 = np.where(swap, pa, pb)
        key = np.minimum(ia, ib) * n_img + np.maximum(ia, ib)
        order = np.argsort(key, kind="stable")
        lay = SegmentLayout.from_sorted_ids(key[order], n_img * n_img)
        return PairPlan(
            pa=jnp.asarray(pa2[order].astype(np.int32)),
            pb=jnp.asarray(pb2[order].astype(np.int32)),
            key_begs=lay.begs,
            key_ends=lay.ends,
        )

    @property
    def n_pairs(self):
        return self.pa.shape[0]


def coupling_factors(fac):
    """Mt_o = (Je' W Jp)_o @ chol(Hpp^-1_tie(o)) as a flat (N, ne*3)
    stream, plus the unwhitened D_o = (Je' W Jp)_o (N, ne*3).

    Rows of control observations (tie == n_tie) are zero (their Jp rows
    are masked in SchurFactors and the dummy L row is zero)."""
    k = fac.k
    ne, nt = k.ne, k.n_tie
    wx, wy = fac._w
    Jpwx = fac.Jpx * wx[:, None]
    Jpwy = fac.Jpy * wy[:, None]
    D = jnp.stack(
        [
            fac.Jex[:, e] * Jpwx[:, p] + fac.Jey[:, e] * Jpwy[:, p]
            for e in range(ne)
            for p in range(3)
        ],
        axis=1,
    )  # (N, ne*3) = Je' W Jp per observation, row-major (e, p)
    L9 = point_chol_flat(fac)  # (nt + 1, 9) with zero dummy row
    Lg = L9[fac.obs.tie]  # (N, 9) row gather
    Mt = _flat_ab(D, Lg, ne, 3, 3)  # (N, ne*3)
    return Mt, D


def point_chol_flat(fac):
    """chol(Hpp^-1) per tie as flat (n_tie + 1, 9) rows (zero dummy)."""
    nt = fac.k.n_tie
    H9 = fac.Hpi_flat[:nt]
    # tiny jitter keeps the Cholesky finite on degenerate (rank<3) points;
    # such points are equally degenerate in the matrix-free path.
    jit9 = jnp.zeros((1, 9), H9.dtype).at[0, jnp.asarray([0, 4, 8])].set(1e-30)
    L9 = _chol3x3_flat(H9 + jit9)
    return jnp.concatenate([L9, jnp.zeros((1, 9), L9.dtype)], axis=0)


def _blocks_to_dense(U, n_img, ne):
    """(n_img^2, ne*ne) block table -> dense (n_img*ne, n_img*ne).

    Stays in 2-D/clean-minor layouts: the only rank>2 intermediate has a
    large minor dimension, avoiding the (8, 128) trailing-dim padding."""
    # (ia*n+ib, e*ne+f) -> (ia, e*ne+f, ib): minor dims (ne*ne, n_img)
    T = jnp.transpose(U.reshape(n_img, n_img, ne * ne), (0, 2, 1))
    # -> (ia, e, f, ib) -> (ia, e, ib, f): trailing dims (ib, f) pad 21x,
    # but XLA fuses this transpose into the copy that writes the final 2-D
    # reshape, so the padded form is never materialized.
    T = jnp.transpose(T.reshape(n_img, ne, ne, n_img), (0, 1, 3, 2))
    return T.reshape(n_img * ne, n_img * ne)


def build_dense_S(fac, pairs: PairPlan):
    """Materialize the dense reduced camera system S (nc x nc) from one
    linearization point."""
    k = fac.k
    ne, ni = k.ne, k.ni
    n_img = k.n_img
    wx, wy = fac._w
    dtype = fac.rx.dtype

    Mt, _D = coupling_factors(fac)  # (N, ne*3)

    # ---- pose-pose: Hcc diag + pair correction --------------------------
    # self pairs a == b: sum_o Mt_o Mt_o' per image (image-axis plan)
    self_outer = _flat_abt(Mt, Mt, ne, ne, 3)
    hcc_cols = jnp.stack(
        [
            wx * fac.Jex[:, e] * fac.Jex[:, f]
            + wy * fac.Jey[:, e] * fac.Jey[:, f]
            for e in range(ne)
            for f in range(ne)
        ],
        axis=1,
    )  # (N, ne*ne)
    per_img = fac.obs.plan.secondary_sum(hcc_cols - self_outer)

    # cross pairs a < b (block-key sorted): gather, product, segment-sum
    A = Mt[pairs.pa]
    B = Mt[pairs.pb]
    prod = _flat_abt(A, B, ne, ne, 3)  # (P, ne*ne)
    U = sorted_segment_sum(
        prod, SegmentLayout(begs=pairs.key_begs, ends=pairs.key_ends)
    )  # (n_img^2, ne*ne)
    # mirror the strictly-upper blocks: U_full[ia, ib] = U[ia, ib] and
    # U_full[ib, ia] = U[ia, ib]'  (diagonal blocks ia == ib appear once
    # in U and need their transpose added: a<b pairs contribute only one
    # orientation)
    Ut = jnp.transpose(U.reshape(n_img, n_img, ne * ne), (1, 0, 2)).reshape(
        n_img * n_img, ne * ne
    )
    tr_cols = jnp.asarray(
        [(f * ne + e) for e in range(ne) for f in range(ne)]
    )
    U_full = U + Ut[:, tr_cols]
    S = -_blocks_to_dense(U_full, n_img, ne)
    # add Hcc - self-pair correction on the block diagonal
    ar = jnp.arange(n_img)
    rows = (ar[:, None, None] * ne + jnp.arange(ne)[:, None]) * (
        n_img * ne
    ) + (ar[:, None, None] * ne + jnp.arange(ne)[None, :])
    S = S.reshape(-1).at[rows.reshape(-1)].add(
        per_img.reshape(n_img, ne, ne).reshape(-1)
    ).reshape(n_img * ne, n_img * ne)

    if ni:
        S = _append_iop_borders(fac, Mt, S)

    if k.opts.camera_damping:
        S = S + k.opts.camera_damping * jnp.eye(k.nc, dtype=dtype)
    return S


def _append_iop_borders(fac, Mt, S):
    """Extend the pose-pose S with the IOP coupling columns/rows and the
    IOP-IOP block (full self-calibration, reference stage 3)."""
    k = fac.k
    ne, ni, nt, n_cam, n_img = k.ne, k.ni, k.n_tie, k.n_cam, k.n_img
    wx, wy = fac._w
    dtype = fac.rx.dtype

    Jpwx = fac.Jpx * wx[:, None]
    Jpwy = fac.Jpy * wy[:, None]
    Fi = jnp.stack(
        [
            fac.Jix[:, i] * Jpwx[:, p] + fac.Jiy[:, i] * Jpwy[:, p]
            for i in range(ni)
            for p in range(3)
        ],
        axis=1,
    )  # (N, ni*3) = Ji' W Jp per observation
    hii_cols = jnp.stack(
        [
            wx * fac.Jix[:, i] * fac.Jix[:, j]
            + wy * fac.Jiy[:, i] * fac.Jiy[:, j]
            for i in range(ni)
            for j in range(ni)
        ],
        axis=1,
    )  # (N, ni*ni)
    L9 = point_chol_flat(fac)  # (nt + 1, 9)

    if n_cam == 1:
        Ei = fac.obs.plan.primary_sum(Fi)[:nt]  # (nt, ni*3)
        EiL = _flat_ab(Ei, L9[:nt], ni, 3, 3)  # (nt, ni*3)
        Sii = jnp.sum(hii_cols, axis=0).reshape(ni, ni) - _sum_abt(
            EiL, EiL, ni, 3
        )
        if ne:
            EiL_pad = jnp.concatenate(
                [EiL, jnp.zeros((1, ni * 3), dtype)], axis=0
            )
            Eg = EiL_pad[fac.obs.tie]  # (N, ni*3)
            cross = _flat_abt(Mt, Eg, ne, ni, 3)  # (N, ne*ni)
            hci_cols = jnp.stack(
                [
                    wx * fac.Jex[:, e] * fac.Jix[:, i]
                    + wy * fac.Jey[:, e] * fac.Jiy[:, i]
                    for e in range(ne)
                    for i in range(ni)
                ],
                axis=1,
            )
            Sei = fac.obs.plan.secondary_sum(hci_cols - cross).reshape(
                n_img * ne, ni
            )
            top = jnp.concatenate([S, Sei], axis=1)
            bot = jnp.concatenate([Sei.T, Sii], axis=1)
            return jnp.concatenate([top, bot], axis=0)
        return Sii

    # multi-camera: per-(tie, camera) IOP aggregates
    keyo = jnp.minimum(fac.obs.tie, nt) * n_cam + fac.obs.cam
    Ei = (
        jnp.zeros(((nt + 1) * n_cam, ni * 3), dtype).at[keyo].add(Fi)
    )[: nt * n_cam]
    L9_cam = jnp.repeat(L9[:nt], n_cam, axis=0)  # (nt*n_cam, 9)
    EiL = _flat_ab(Ei, L9_cam, ni, 3, 3)  # (nt*n_cam, ni*3)
    Hii = jnp.zeros((n_cam, ni * ni), dtype).at[fac.obs.cam].add(hii_cols)
    corr = _cross_cam_corr(EiL, nt, n_cam, ni)  # (n_cam*ni, n_cam*ni)
    car = jnp.arange(n_cam)
    Sii = -corr
    Sii = Sii.reshape(n_cam, ni, n_cam, ni).at[car, :, car, :].add(
        Hii.reshape(n_cam, ni, ni)
    ).reshape(n_cam * ni, n_cam * ni)
    if not k.ne:
        return Sii
    EiL_pad = jnp.concatenate([EiL, jnp.zeros((n_cam, ni * 3), dtype)], 0)
    hci_cols = jnp.stack(
        [
            wx * fac.Jex[:, e] * fac.Jix[:, i]
            + wy * fac.Jey[:, e] * fac.Jiy[:, i]
            for e in range(ne)
            for i in range(ni)
        ],
        axis=1,
    )
    img_cam = jnp.asarray(k.layout.problem.img_cam)
    # The direct Hci term exists only for an image's OWN camera (each
    # observation's Ji columns live in one camera's block), but the
    # point-elimination correction couples every image to EVERY camera's
    # IOPs through shared tie points: Sei[a, c] = Hci(a) [cam(a)==c]
    # - sum_{o in a} Mt_o @ EiL[tie(o), c]'.  (The r1-r4 form masked the
    # whole column block to the own camera, silently dropping the
    # cross-camera corrections — wrong steps for n_cam > 1 self-cal.)
    cam_blocks = []
    tie_clip = jnp.minimum(fac.obs.tie, nt)
    own = fac.obs.cam  # (N,) this observation's camera
    for c in range(n_cam):
        key_c = tie_clip * n_cam + c
        # control rows (tie == nt) land in the zero pad rows
        key_c = jnp.where(fac.obs.tie >= nt, nt * n_cam + c, key_c)
        Eg_c = EiL_pad[key_c]  # (N, ni*3)
        cross_c = _flat_abt(Mt, Eg_c, ne, ni, 3)  # (N, ne*ni)
        direct_c = hci_cols * (own == c)[:, None]
        per_img_c = fac.obs.plan.secondary_sum(direct_c - cross_c)
        cam_blocks.append(
            per_img_c.reshape(n_img, ne, ni).reshape(n_img * ne, ni)
        )
    Sei = jnp.concatenate(cam_blocks, axis=1)  # (n_img*ne, n_cam*ni)
    top = jnp.concatenate([S, Sei], axis=1)
    bot = jnp.concatenate([Sei.T, Sii], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _sum_abt(A, B, m, k):
    """sum_r A_r B_r' over all rows: (r, m*k) x (r, m*k) -> (m, m)."""
    out = jnp.stack(
        [
            jnp.sum(
                sum(A[:, i * k + q] * B[:, j * k + q] for q in range(k))
            )
            for i in range(m)
            for j in range(m)
        ]
    )
    return out.reshape(m, m)


def _cross_cam_corr(EiL, nt, n_cam, ni):
    """sum_t EiL[t, c1] EiL[t, c2]' -> (n_cam*ni, n_cam*ni)."""
    E = EiL.reshape(nt, n_cam * ni * 3)
    G = E.T @ E  # (n_cam*ni*3, n_cam*ni*3) — small (contract over ties)
    G4 = G.reshape(n_cam * ni, 3, n_cam * ni, 3)
    return jnp.trace(
        jnp.transpose(G4, (0, 2, 1, 3)), axis1=2, axis2=3
    )


def dense_precond(S, kernel):
    """Exact Schur-Jacobi preconditioner read off the dense S diagonal.

    Unlike the matrix-free ``make_preconditioner`` (whose IOP block omits
    the point-elimination correction), both blocks here are true diagonal
    blocks of S."""
    ne, ni, n_img = kernel.ne, kernel.ni, kernel.n_img
    nc = kernel.nc
    io = n_img * ne
    flat = S.reshape(-1)
    ar = jnp.arange(n_img)
    idx = (
        (ar[:, None, None] * ne + jnp.arange(ne)[:, None]) * nc
        + ar[:, None, None] * ne
        + jnp.arange(ne)[None, :]
    )
    Pb = jnp.linalg.inv(flat[idx.reshape(-1)].reshape(n_img, ne, ne))
    if ni:
        n_cam = kernel.n_cam
        car = jnp.arange(n_cam)
        idx_i = (
            (io + car[:, None, None] * ni + jnp.arange(ni)[:, None]) * nc
            + io
            + car[:, None, None] * ni
            + jnp.arange(ni)[None, :]
        )
        Ib = jnp.linalg.inv(
            flat[idx_i.reshape(-1)].reshape(n_cam, ni, ni)
        )

    def apply(vc):
        vp = vc[:io].reshape(n_img, ne)
        parts = [jnp.einsum("bij,bj->bi", Pb, vp).reshape(-1)]
        if ni:
            vi = vc[io:].reshape(kernel.n_cam, ni)
            parts.append(jnp.einsum("bij,bj->bi", Ib, vi).reshape(-1))
        return jnp.concatenate(parts)

    return apply
