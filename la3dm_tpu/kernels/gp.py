"""Batched Gaussian-process regression for GPOctoMap.

The reference runs one exact GP per block: Matérn-3/2 Gram matrix + LLT
Cholesky at train time (``gpregressor.h:42-51``), triangular solve + variance
at predict time (``gpregressor.h:80-92``).  Here blocks are padded to a
common point count and solved as one batched Cholesky
(``jax.lax.linalg``), with padding points placed at a far-away coordinate so
their kernel rows vanish and the padded system block-diagonalises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from la3dm_tpu.kernels import math as km

PAD_COORD = 1.0e6  # far enough that Matérn(d) underflows to exactly 0


def pad_points(points: jax.Array, valid: jax.Array) -> jax.Array:
    """Move padded rows to a far coordinate staggered per row.

    Staggering (PAD_COORD · (1 + row/S)) keeps padded points apart from each
    other, so the padded diagonal block of the Gram matrix is (sf2+noise)·I —
    strictly PD, with zero coupling to real points.
    """
    S = points.shape[-2]
    stagger = PAD_COORD * (1.0 + jnp.arange(S, dtype=jnp.float32) / S)
    far = jnp.stack([stagger, stagger, stagger], axis=-1)
    return jnp.where(valid[..., None], points, far)


def gp_train_core(points: jax.Array, labels: jax.Array, valid: jax.Array,
                  sf2: float, ell: float, noise: float) -> tuple[jax.Array, jax.Array]:
    """Batched GP training (gpregressor.h:42-51) — traceable core.

    Args:
      points: [B,S,3] block-local training points (padded).
      labels: [B,S] targets (+1 occupied / −1 free), zero on padding.
      valid:  [B,S] padding mask.
    Returns:
      L:     [B,S,S] Cholesky factors of K + noise·I.
      alpha: [B,S]   K⁻¹y (zero on padded rows).
    """
    pts = pad_points(points, valid)
    y = jnp.where(valid, labels, 0.0)

    def per_block(x, yy):
        K = km.cov_matern32(x, x, sf2, ell) + jnp.float32(noise) * jnp.eye(x.shape[0], dtype=jnp.float32)
        L = jax.lax.linalg.cholesky(K, symmetrize_input=False)
        z = jax.lax.linalg.triangular_solve(L, yy[:, None], left_side=True, lower=True)
        a = jax.lax.linalg.triangular_solve(L, z, left_side=True, lower=True, transpose_a=True)
        return L, a[:, 0]

    return jax.vmap(per_block)(pts, y)


def gp_predict_core(L: jax.Array, alpha: jax.Array, points: jax.Array, valid: jax.Array,
                    xs: jax.Array, sf2: float, ell: float) -> tuple[jax.Array, jax.Array]:
    """Batched GP prediction (gpregressor.h:80-92) — traceable core.

    Args:
      L, alpha: training results for B models.
      points:   [B,S,3] the models' training points (padded).
      valid:    [B,S].
      xs:       [B,M,3] test points per model (block-local coords).
    Returns:
      mean [B,M], var [B,M] with var = sf2 − Σ v², v = L⁻¹ Ks.
    """
    pts = pad_points(points, valid)

    def per_block(Lb, ab, x, q):
        Ks = km.cov_matern32(x, q, sf2, ell)              # [S,M]
        mean = jnp.dot(Ks.T, ab[:, None], precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)[:, 0]
        v = jax.lax.linalg.triangular_solve(Lb, Ks, left_side=True, lower=True)
        var = jnp.float32(sf2) - jnp.sum(v * v, axis=0)
        return mean, var

    return jax.vmap(per_block)(L, alpha, pts, xs)


def bcm_update_sequential(m_ivar: jax.Array, ivar: jax.Array,
                          means: jax.Array, variances: jax.Array, present: jax.Array,
                          sf2: float, min_known_ivar: float, max_ivar: float) -> tuple[jax.Array, jax.Array]:
    """Sequential BCM fusion over neighbor slots with the reference's ivar chop.

    ``Occupancy::update`` (gpoctree_node.cpp:36-49) mutates
    ``ivar += 1/var − sf2; m_ivar += m/var`` and then *persistently* clamps
    ivar to max_ivar whenever ivar ≥ min_known_ivar — an order-dependent
    nonlinearity, so the G neighbor models are applied in ExtendedBlock order
    via a scan rather than summed.

    Args:
      m_ivar, ivar: [...,] current state.
      means, variances: [..., G] per-slot predictions.
      present: [..., G] bool, slot has a trained model.
    """
    def step(carry, inp):
        mi, iv = carry
        m, var, ok = inp
        iv_new = iv + 1.0 / var - jnp.float32(sf2)
        mi_new = mi + m / var
        chop = iv_new >= jnp.float32(min_known_ivar)
        iv_new = jnp.where(chop, jnp.minimum(iv_new, jnp.float32(max_ivar)), iv_new)
        return (jnp.where(ok, mi_new, mi), jnp.where(ok, iv_new, iv)), None

    xs = (jnp.moveaxis(means, -1, 0), jnp.moveaxis(variances, -1, 0), jnp.moveaxis(present, -1, 0))
    (mi, iv), _ = jax.lax.scan(step, (m_ivar, ivar), xs)
    return mi, iv
