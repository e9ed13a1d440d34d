"""Covariance kernels and distances — the math of §2.3 of the reference.

All functions are pure and float32, and evaluate whole [M,N] blocks at once
rather than the reference's row-at-a-time Eigen loops
(``bgkinference.h:88-93``).  Pairwise distances use direct per-axis
subtraction, not the Gram expansion ``|a|² + |b|² − 2a·bᵀ``
(see :func:`pairwise_dist`).

Reference formulas (float32 constants preserved exactly):
* sparse (Melkumyan-Ramos) kernel: ``sf2·[(2+cos 2πr)(1−r)/3 + sin(2πr)/2π]``
  with r = d/ℓ, negatives clamped to 0 (``bgkinference.h:113-126``).
* Matérn-3/2: ``sf2·(1+√3 d/ℓ)·exp(−√3 d/ℓ)`` with √3 ≈ 1.73205
  (``gpregressor.h:114-117``).
* point-to-segment distance: project, clamp to endpoints, ε = 1e-4 for
  degenerate segments (``bgklinference.h:106-141``).
* LV variant: clamp r ≤ 1 *before* the kernel instead of clamping negative
  outputs (``bgklvinference.h:143-157``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# numpy f32 scalars (not jnp arrays): compile-time constants under jit with
# arithmetic identical to the numpy reference paths
import numpy as _np

TWO_PI = _np.float32(2.0 * 3.1415926)  # reference uses 3.1415926f
SQRT3 = _np.float32(1.73205)
SEG_EPSILON = _np.float32(1e-4)


def pairwise_dist(a: jax.Array, b: jax.Array) -> jax.Array:
    """Euclidean distance matrix [M,N] between a [M,3] and b [N,3].

    Direct per-axis subtraction, matching the reference's Eigen rowwise norm
    (``bgkinference.h:88-93``) to float32 roundoff.  (The Gram expansion
    |a|²+|b|²−2a·bᵀ is one matmul but loses ~3 digits near the kernel
    support boundary, which flips clamp decisions vs the reference — measured
    5.8e-3 worst-case kernel deviation on block-local data.)
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    d2 = jnp.zeros((a.shape[0], b.shape[0]), jnp.float32)
    for ax in range(a.shape[-1]):
        diff = a[:, ax:ax + 1] - b[None, :, ax]
        d2 = d2 + diff * diff
    return jnp.sqrt(d2)


def sparse_kernel(r: jax.Array, sf2: float) -> jax.Array:
    """Sparse kernel on normalised distance r = d/ℓ, negatives clamped to 0."""
    k = ((2.0 + jnp.cos(TWO_PI * r)) * (1.0 - r) / 3.0 + jnp.sin(TWO_PI * r) / TWO_PI) * _np.float32(sf2)
    return jnp.maximum(k, 0.0)


def sparse_kernel_lv(r: jax.Array, sf2: float) -> jax.Array:
    """LV sparse kernel: r clamped to ≤ 1 before the kernel, no output clamp."""
    r = jnp.minimum(r, 1.0)
    return ((2.0 + jnp.cos(TWO_PI * r)) * (1.0 - r) / 3.0 + jnp.sin(TWO_PI * r) / TWO_PI) * _np.float32(sf2)


def matern32(d: jax.Array, sf2: float, ell: float) -> jax.Array:
    """Matérn-3/2 on raw distance d (the √3/ℓ scaling applied internally)."""
    s = SQRT3 / _np.float32(ell) * d
    return (1.0 + s) * jnp.exp(-s) * _np.float32(sf2)


def cov_sparse(x: jax.Array, z: jax.Array, sf2: float, ell: float) -> jax.Array:
    """covSparse (bgkinference.h:113-126): sparse kernel of dist(x/ℓ, z/ℓ).

    Division (not reciprocal multiply) — the k̄>0 update gate is sensitive to
    the last ulp at the kernel's support boundary.
    """
    e = _np.float32(ell)
    return sparse_kernel(pairwise_dist(x / e, z / e), sf2)


def cov_matern32(x: jax.Array, z: jax.Array, sf2: float, ell: float) -> jax.Array:
    """covMaterniso3 (gpregressor.h:114-117); scale computed in double as the
    reference's ``1.73205 / ell`` promotes to double before the f32 matmul."""
    s = _np.float32(1.73205 / float(ell))
    d = pairwise_dist(x * s, z * s)
    return (1.0 + d) * jnp.exp(-d) * _np.float32(sf2)


def point_to_segment_dist(p: jax.Array, seg: jax.Array) -> jax.Array:
    """Distance matrix [M,N]: points p [M,3] to segments seg [N,6] (start,end).

    Branch structure matches bgklinference.h:106-141:
      |p1−p0| < ε          → |p − p0|
      c1 = (p−p0)·u ≤ 0    → |p − p0|
      c2 = u·u ≤ c1        → |p − p1|
      else                 → |p − (p0 + u·c1/c2)|
    with c1, c2 computed in float64 (the reference uses double there).
    """
    p = p.astype(jnp.float32)
    p0 = seg[:, 0:3].astype(jnp.float32)
    p1 = seg[:, 3:6].astype(jnp.float32)
    u = p1 - p0                                  # [N,3]
    line_len = jnp.sqrt(u[:, 0] ** 2 + u[:, 1] ** 2 + u[:, 2] ** 2)

    # per-axis accumulation keeps every intermediate [M,N] (x+y+z in the
    # same order as the axis-(-1) reductions it replaces — bit-identical):
    # [M,N,3] intermediates put 3 in the lane dimension, a 42× lane waste
    # that dominated the LV tile engine's device profile (r5)
    d0sq = jnp.zeros((p.shape[0], p0.shape[0]), jnp.float32)
    d1sq = jnp.zeros_like(d0sq)
    c1 = jnp.zeros_like(d0sq)
    for ax in range(3):
        diff0 = p[:, ax:ax + 1] - p0[None, :, ax]            # [M,N]
        d0sq = d0sq + diff0 * diff0
        diff1 = p[:, ax:ax + 1] - p1[None, :, ax]
        d1sq = d1sq + diff1 * diff1
        c1 = c1 + diff0 * u[None, :, ax]
    d0 = jnp.sqrt(d0sq)
    d1 = jnp.sqrt(d1sq)
    c2 = (u[:, 0] ** 2 + u[:, 1] ** 2 + u[:, 2] ** 2)[None, :]   # [1,N]
    b = c1 / jnp.maximum(c2, 1e-30)
    dmidsq = jnp.zeros_like(d0sq)
    for ax in range(3):
        dm = p[:, ax:ax + 1] - (p0[None, :, ax] + u[None, :, ax] * b)
        dmidsq = dmidsq + dm * dm
    dmid = jnp.sqrt(dmidsq)

    d = jnp.where(c1 <= 0.0, d0, jnp.where(c2 <= c1, d1, dmid))
    return jnp.where(line_len[None, :] < SEG_EPSILON, d0, d)


def cov_sparse_segment(p: jax.Array, seg: jax.Array, sf2: float, ell: float,
                       lv: bool = False) -> jax.Array:
    """covSparseLine: sparse kernel of point-to-segment distance / ℓ.

    ``lv=False`` → BGKL semantics (clamp negative outputs, bgklinference.h:183-197);
    ``lv=True``  → LV semantics (clamp r ≤ 1 first, bgklvinference.h:143-157).
    """
    r = point_to_segment_dist(p, seg) / _np.float32(ell)
    return sparse_kernel_lv(r, sf2) if lv else sparse_kernel(r, sf2)
