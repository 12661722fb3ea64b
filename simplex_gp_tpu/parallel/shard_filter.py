"""Data-sharded lattice filter: explicit shard_map building blocks.

The reference is single-device (SURVEY.md section 2.7); this module is the
multi-device formulation of the permutohedral filter.  Sharding
model over a 1-D mesh axis (default ``"data"``):

  * every shard holds n_loc = n / P input points; geometry (elevate / round /
    rank / barycentric -> vertex hashes + coordinate sums) is computed
    locally -- the O(n) work parallelizes perfectly;
  * the per-vertex (hash pair, coordinate sum) triples (12 bytes/vertex) are
    ``all_gather``-ed so every shard deterministically builds the IDENTICAL
    global chain tables (the lattice is the global shared state of this
    workload -- the analogue of the KV ring in ring attention);
  * splat produces per-shard partial lattice tables combined with ONE
    ``psum`` per filter application; the blur (shift stencils + transition
    sorts, O(M)) runs replicated; slice reads back only local rows.

Communication per MVM: one psum of the (M, c) table.  Per plan build: one
all_gather of 12 bytes/vertex.  CG / Lanczos / NLML reductions take the same
``axis_name`` (linalg/cg.py, linalg/lanczos.py, linalg/mll.py).

Engines: the sort-chain plan (ops/lattice.py) is the default;
``build_plan_sharded_join`` keeps the gather-based join engine for
differential testing and wide value matrices.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.lattice import (
    ChainPlan,
    LatticePlan,
    _chain_core,
    _hash_pair,
    _hash_vectors,
    _plan_tables,
    _point_hashes,
    apply_plan,
    build_rotation,
    lattice_simplex,
)

__all__ = ["build_plan_sharded", "build_plan_sharded_join", "filter_sharded"]


def build_plan_sharded(
    x_local: jax.Array, coeffs: tuple, blur_variance: float, axis_name: str
) -> ChainPlan:
    """Per-shard sort-chain plan against the global lattice (inside shard_map).

    ``dest``/``weights``/``slice_idx`` cover only this shard's rows (dest
    routes local contributions to GLOBAL table positions; cnt counts LOCAL
    contributions per global row, so the per-shard splat partial tables sum
    to the global table under one psum).  k1/k2/tapw and the implied table
    capacity M = n_global*(d+1) are global and identical on every shard
    (deterministic function of the all-gathered hash triples).
    """
    cs = np.asarray(coeffs, np.float64)
    if not np.allclose(cs, cs[::-1]):
        raise ValueError("chain plan requires symmetric filter taps")
    n_loc, d = x_local.shape
    dp1 = d + 1
    order = (len(coeffs) - 1) // 2
    n_vert = n_loc * dp1
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)

    keys, weights = lattice_simplex(x_local.astype(jnp.float32), E)
    flat = keys.reshape(n_vert, d)
    h1_loc, h2_loc = _hash_pair(flat, a)
    s_loc = flat.sum(-1)
    # Vertex-major LOCAL contribution order (matching build_plan_chain's
    # layout discipline); the all-gathered global arrays are then
    # shard-major blocks of vertex-major rows, so dest/seg windows stay
    # contiguous per shard.
    vm = lambda t: t.reshape(n_loc, dp1).T.reshape(-1)
    h1_loc, h2_loc, s_loc = vm(h1_loc), vm(h2_loc), vm(s_loc)

    g1 = jax.lax.all_gather(h1_loc, axis_name, tiled=True)  # (N_global*(d+1),)
    g2 = jax.lax.all_gather(h2_loc, axis_name, tiled=True)
    gs = jax.lax.all_gather(s_loc, axis_name, tiled=True)

    dest, seg_orig, _, k1, k2, tapw, rank_d, n_lattice = _chain_core(
        g1, g2, gs, d, order, cs
    )
    M = g1.shape[0]

    shard = jax.lax.axis_index(axis_name)
    start = shard * n_vert
    dest_loc = jax.lax.dynamic_slice_in_dim(dest, start, n_vert)
    seg_loc = jax.lax.dynamic_slice_in_dim(seg_orig, start, n_vert)

    # Local cumulative contribution counts per global table row: the local
    # splat cumsum is indexed by these (apply_plan_chain), yielding this
    # shard's partial table (zero rows where the shard has no contribution).
    counts = jax.ops.segment_sum(
        jnp.ones((n_vert,), jnp.int32), seg_loc, num_segments=M
    )
    cnt_loc = jnp.cumsum(counts).astype(jnp.int32)

    slice_idx = rank_d[seg_loc]  # flat vertex-major (n_loc*(d+1),)
    return ChainPlan(
        dest=dest_loc,
        cnt=cnt_loc,
        k1=k1,
        k2=k2,
        tapw=tapw,
        slice_idx=slice_idx,
        weights=weights.T.reshape(-1),
        n_lattice=n_lattice,
    )


def build_plan_sharded_join(
    x_local: jax.Array, coeffs: tuple, blur_variance: float, axis_name: str
) -> LatticePlan:
    """Join-engine variant of :func:`build_plan_sharded` (gather-based blur;
    column-count-independent apply).  Kept for differential testing and wide
    value matrices."""
    n_loc, d = x_local.shape
    dp1 = d + 1
    order = (len(coeffs) - 1) // 2
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)

    h1, h2, weights = _point_hashes(x_local, E, a)
    g1 = jax.lax.all_gather(h1, axis_name, tiled=True)  # (N_global,)
    g2 = jax.lax.all_gather(h2, axis_name, tiled=True)
    seg_all, neighbors, n_lattice = _plan_tables(g1, g2, d, order, a)

    shard = jax.lax.axis_index(axis_name)
    n_vert = n_loc * dp1
    seg_local = jax.lax.dynamic_slice_in_dim(seg_all, shard * n_vert, n_vert)
    return LatticePlan(
        seg_ids=seg_local.reshape(n_loc, dp1),
        weights=weights,
        neighbors=neighbors,
        n_lattice=n_lattice,
    )


def filter_sharded(src_local, ref_local, dk, axis_name: str):
    """K(ref, ref) @ src with both sharded over the data axis (in shard_map).

    Differentiable by plain autodiff: the all_gather/psum collectives
    transpose to psum_scatter/identity under JAX AD, so hyperparameter
    gradients flow across shards exactly (the sharded analogue of
    ops/filter.py lattice_filter_exact_grad).
    """
    plan = build_plan_sharded(ref_local, dk.coeffs, dk.variance, axis_name)
    return apply_plan(plan, src_local, dk.coeffs, axis_name=axis_name)
