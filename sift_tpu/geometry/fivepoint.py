"""Batched Nistér 5-point minimal solver for the essential matrix.

The reference has no epipolar geometry at all (it stops at a 2-D
homography, src/main.cpp:54); this is north-star capability. The
classic 5-point derivations hand-code the 10x20 constraint-polynomial
coefficient table; here the table is built NUMERICALLY — each entry of
E = xX + yY + zZ + W is a linear polynomial in (x, y, z) represented
as a tiny (2,2,2) coefficient tensor, and det(E) plus the nine
trace-constraint cubics come out of small 3-D tensor convolutions.
That keeps the whole solver dense, vmappable array math with no
per-sample control flow:

  1. 4-dim nullspace of the 5x9 epipolar system (batched SVD)
  2. 10x20 cubic constraint matrix via coefficient-tensor products
  3. Gauss-Jordan reduction as one 10x10 solve
  4. Nistér's 3x3 polynomial matrix -> degree-10 polynomial in z
     (1-D coefficient convolutions)
  5. all 10 roots at once with Durand-Kerner iteration in complex64
     (XLA has no batched nonsymmetric `eig` on accelerators; DK is
     fixed-iteration elementwise math). Coefficients are rescaled by the Cauchy root
     bound with NEGATIVE powers so complex64 never overflows.
  6. x, y back-substitution per real root (2x2 solves)

At <=50% inlier ratios a 5-point sample survives contamination ~2.4x
more often than an 8-point sample (0.5^5 vs 0.5^8), which is the whole
robustness argument for minimal solvers; tests/test_epipolar.py
measures this against the 8-point path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# monomial order of the 10x20 constraint matrix (Stewénius/Nistér):
# first 10 are eliminated, last 10 = [xz^2, xz, x, yz^2, yz, y,
# z^3, z^2, z, 1] stay as the polynomial part
_MON = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
        (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
        (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
        (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]

_N_DEG = 10
_DK_ITERS = 80


def _pmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Product of two (x, y, z) coefficient tensors (full 3-D conv)."""
    return jax.scipy.signal.convolve(a, b)


def essential_candidates_5pt(p0: jnp.ndarray, p1: jnp.ndarray):
    """5 normalized correspondences (5, 2) x2 -> up to 10 essential
    matrix candidates.

    Returns (es (10, 3, 3) unit-Frobenius, valid (10,) bool). Invalid
    slots (complex roots, degenerate samples) are masked, never NaN-
    scored: callers count inliers per candidate and the mask zeroes
    losers.
    """
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    o = jnp.ones_like(x0)
    a = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                   x0, y0, o], 1)                       # (5, 9)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    basis = vt[5:9]                                     # (4, 9) X,Y,Z,W

    def lin(ix):
        t = jnp.zeros((2, 2, 2))
        t = t.at[1, 0, 0].set(basis[0, ix])
        t = t.at[0, 1, 0].set(basis[1, ix])
        t = t.at[0, 0, 1].set(basis[2, ix])
        t = t.at[0, 0, 0].set(basis[3, ix])
        return t

    e = [[lin(3 * i + j) for j in range(3)] for i in range(3)]

    det = _pmul(e[0][0], _pmul(e[1][1], e[2][2])
                - _pmul(e[1][2], e[2][1])) \
        - _pmul(e[0][1], _pmul(e[1][0], e[2][2])
                - _pmul(e[1][2], e[2][0])) \
        + _pmul(e[0][2], _pmul(e[1][0], e[2][1])
                - _pmul(e[1][1], e[2][0]))

    eet = [[sum(_pmul(e[i][k], e[j][k]) for k in range(3))
            for j in range(3)] for i in range(3)]
    tr = eet[0][0] + eet[1][1] + eet[2][2]
    rows = [det]
    for i in range(3):
        for j in range(3):
            acc = jnp.zeros((4, 4, 4))
            for k in range(3):
                cik = 2.0 * eet[i][k] - (tr if i == k
                                         else jnp.zeros_like(tr))
                acc = acc + _pmul(cik, e[k][j])
            rows.append(acc)
    m = jnp.stack([jnp.stack([r[i, j, k] for (i, j, k) in _MON])
                   for r in rows])                      # (10, 20)
    b = jnp.linalg.solve(m[:, :10], m[:, 10:])          # (10, 10)

    # Nistér row combinations: (row(x^2 z) - z row(x^2)) etc. group the
    # surviving monomials by {x, y, 1} into polynomials in z
    def zpolys(hi, lo):
        bh, bl = b[hi], b[lo]
        px = jnp.array([bh[2], bh[1], bh[0], 0.0]) \
            - jnp.array([0.0, bl[2], bl[1], bl[0]])
        py = jnp.array([bh[5], bh[4], bh[3], 0.0]) \
            - jnp.array([0.0, bl[5], bl[4], bl[3]])
        p1c = jnp.array([bh[9], bh[8], bh[7], bh[6], 0.0]) \
            - jnp.array([0.0, bl[9], bl[8], bl[7], bl[6]])
        return px, py, p1c

    krow = zpolys(4, 5)     # x^2 z, x^2
    lrow = zpolys(6, 7)     # y^2 z, y^2
    mrow = zpolys(8, 9)     # xyz, xy

    def pm(u, v):
        return jnp.convolve(u, v)

    d = pm(krow[0], pm(lrow[1], mrow[2]) - pm(lrow[2], mrow[1])) \
        - pm(krow[1], pm(lrow[0], mrow[2]) - pm(lrow[2], mrow[0])) \
        + pm(krow[2], pm(lrow[0], mrow[1]) - pm(lrow[1], mrow[0]))
    # d: degree-10 coefficients, ascending

    lead = d[-1]
    dn = d / jnp.where(jnp.abs(lead) > 1e-20, lead, 1.0)
    # Fujiwara root bound: 2 max_k |c_{n-k}/c_n|^(1/k). The naive
    # Cauchy bound (1 + max|c_k|) overestimates by orders of magnitude
    # here, which crushes the rescaled roots into a cluster near zero
    # that complex64 Durand-Kerner cannot separate. Rescale with
    # NEGATIVE powers only (r^10 itself can overflow f32).
    ks = jnp.arange(_N_DEG, 0, -1).astype(jnp.float32)
    r_bound = 2.0 * jnp.max(jnp.abs(dn[:-1]) ** (1.0 / ks))
    r_bound = jnp.maximum(r_bound, 1e-6)
    dn = dn * r_bound ** (jnp.arange(_N_DEG + 1)
                          - _N_DEG).astype(jnp.float32)
    dn = dn / dn[-1]
    coeffs = dn.astype(jnp.complex64)
    roots0 = ((0.4 + 0.9j) ** jnp.arange(_N_DEG)).astype(jnp.complex64)

    def dk_step(_, r):
        pz = jnp.polyval(coeffs[::-1], r)
        diff = r[:, None] - r[None, :] + jnp.eye(_N_DEG, dtype=r.dtype)
        return r - pz / jnp.prod(diff, axis=1)

    roots = jax.lax.fori_loop(0, _DK_ITERS, dk_step, roots0) * r_bound
    realish = jnp.abs(roots.imag) < 1e-3 * (1.0 + jnp.abs(roots.real))
    z = roots.real

    def xy_of(zr):
        def ev(p):
            return jnp.polyval(p[::-1], zr)
        a11, a12, b1 = ev(krow[0]), ev(krow[1]), -ev(krow[2])
        a21, a22, b2 = ev(lrow[0]), ev(lrow[1]), -ev(lrow[2])
        det2 = a11 * a22 - a12 * a21
        det2 = jnp.where(jnp.abs(det2) > 1e-12, det2, 1e-12)
        return ((b1 * a22 - b2 * a12) / det2,
                (a11 * b2 - a21 * b1) / det2)

    xs, ys = jax.vmap(xy_of)(z)
    es = (xs[:, None] * basis[0][None, :]
          + ys[:, None] * basis[1][None, :]
          + z[:, None] * basis[2][None, :] + basis[3][None, :])
    es = es.reshape(-1, 3, 3)
    nrm = jnp.linalg.norm(es.reshape(-1, 9), axis=1)
    es = es / jnp.maximum(nrm, 1e-12)[:, None, None]
    valid = realish & jnp.isfinite(es).all(axis=(1, 2))
    return es, valid
