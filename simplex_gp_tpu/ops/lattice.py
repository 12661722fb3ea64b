"""Permutohedral lattice filter as static-shaped XLA operations.

The filter computes ``out = S^T B S v`` where S is the sparse barycentric
splat matrix onto the permutohedral lattice and B is a product of (d+1)
banded blurs along the lattice axes.  This approximates ``K(x, x) @ v`` for a
stationary kernel in O(n d^2 + n L) (reference claim:
``bilateral_kernel.py:83``).

Reference behavior being re-designed (NOT translated): the CPU/CUDA
implementations in ``gpytorch_lattice_kernel/cpp/permutohedral.h`` and
``cuda/permutohedral_cuda_kernel.cu`` use a pointer-chasing hash table with a
replay buffer.  Here the same math becomes static-shaped XLA ops:

  * geometry (elevate / round / rank / barycentric): vectorized tensor math;
    the elevation recurrence (``permutohedral.h:397-402``) is folded into a
    single (d+1) x d matrix (one matmul, at full f32 precision);
  * hash table -> sort-based dedup (lexsort + segment ids), with the static
    capacity bound M = n*(d+1) (the same bound the CUDA backend uses,
    ``permutohedral_cuda_kernel.cu:61``);
  * blur neighbor lookup -> vectorized lexicographic binary search over the
    sorted unique keys, precomputed ONCE into an index table;
  * splat = segment_sum, blur = gathers + (2r+1)-tap weighted sum per axis,
    slice = gather + barycentric weighted sum.

The key architectural difference from the reference: everything that depends
only on positions (keys, dedup, neighbor indices, barycentric weights) is a
reusable ``LatticePlan``.  A conjugate-gradient solve applies the same kernel
operator hundreds of times; the reference rebuilds its hash table on every
single MVM, while we build the plan once per loss evaluation and each MVM is
pure segment_sum/gather arithmetic.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LatticePlan",
    "ChainPlan",
    "build_rotation",
    "lattice_simplex",
    "build_plan",
    "apply_plan",
    "build_plan_join",
    "apply_plan_join",
    "build_plan_chain",
    "apply_plan_chain",
    "count_lattice_points",
    "filter_once",
    "filter_fused",
    "SLICE_NORM",
]

# Sentinel hash for empty lattice-table rows.  INT32_MAX sorts after (or ties
# with) every real hash, keeping the padded unique-hash array pair-sorted for
# the binary search; the exact-match check rejects sentinel hits.
_KEY_SENTINEL = np.int32(2**31 - 1)

# Above this many sort rows, the neighbor join falls back from one fused sort
# to per-axis joins to bound peak device memory (3 int32 arrays of this
# length live inside the sort).  64M rows ~= 0.8 GB per operand.  The size
# gates in this module were set for a device with a fifth of the H100's
# memory and are untuned on the H100.
_FUSED_JOIN_MAX_ROWS = 64 * 1024 * 1024

# Same idea for the chain-plan mid-axes build: above this many (axis, row)
# entries the batched 4-operand transition sort is chunked one axis at a
# time (lax.map) to bound peak device memory.
_FUSED_BUILD_MAX_ROWS = 32 * 1024 * 1024

# Leader compaction strategy switch.  When the trimmed table capacity Mc is
# both small in absolute terms and a small fraction of the contribution count
# M, the full-M "pull group leaders to the front" sort (5 int32 operands over
# every contribution row) is replaced by a binary search: the g-th leader sits
# at searchsorted(seg_sorted, g) because seg_sorted is non-decreasing, so Mc
# log2(M) gathered rows replace a full sort pass over 5*M rows.  At the
# precipitation geometry (Mc = 8k of M = 2.5M) that is ~200x less traffic;
# at moderate occupancy the gathers can lose to the sort, hence both gates
# (their values are untuned on the H100).
_COMPACT_SEARCH_MAX_MC = 128 * 1024
_COMPACT_SEARCH_MIN_RATIO = 8


def _leader_positions(seg_sorted: jax.Array, Mc: int, M: int) -> jax.Array:
    """Positions of the first row of each of the first ``Mc`` segments.

    ``seg_sorted`` must be non-decreasing (cumsum of group-leader flags).
    Entries for segments beyond the last live one come back as M (the
    insertion point past the end), matching the sort-based compaction's
    convention that dead rows carry no usable position; callers clamp
    before gathering.
    """
    g = jnp.arange(Mc, dtype=seg_sorted.dtype)
    return jnp.searchsorted(seg_sorted, g, side="left").astype(jnp.int32)


def SLICE_NORM(d: int) -> float:
    """Slice normalization constant 1/(1 + 2^-d) (permutohedral.h:507)."""
    return 1.0 / (1.0 + 2.0 ** (-d))


def build_rotation(d: int, blur_variance: float) -> np.ndarray:
    """(d+1) x d elevation matrix E with calibrated scale folded in.

    ``elevated = x @ E.T`` reproduces the reference's per-point recurrence
    (permutohedral.h:397-402) with scale factors
    ``(d+1) * sqrt(var + 1/6) / sqrt((i+1)(i+2))`` (permutohedral.h:371-391):
    the lattice spacing is calibrated so splat+blur+slice has the variance of
    a unit Gaussian per input dimension.
    """
    scale = np.array(
        [(d + 1) * math.sqrt(blur_variance + 1.0 / 6.0) / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
        dtype=np.float64,
    )
    E = np.zeros((d + 1, d), dtype=np.float64)
    for j in range(d):
        sx = np.zeros(d)
        sx[j] = scale[j]
        elevated = np.zeros(d + 1)
        elevated[d] = -d * sx[d - 1]
        for i in range(d - 1, 0, -1):
            elevated[i] = elevated[i + 1] - i * sx[i - 1] + (i + 2) * sx[i]
        elevated[0] = elevated[1] + 2 * sx[0]
        E[:, j] = elevated
    return E.astype(np.float32)


def _canonical_simplex(d: int) -> np.ndarray:
    """Canonical simplex vertex table, (d+1) remainders x (d+1) ranks (permutohedral.h:364-369)."""
    can = np.zeros((d + 1, d + 1), dtype=np.int32)
    for i in range(d + 1):
        can[i, : d + 1 - i] = i
        can[i, d + 1 - i :] = i - (d + 1)
    return can


def lattice_simplex(x: jax.Array, E: jax.Array):
    """Enclosing-simplex geometry for every point: keys, barycentric weights.

    Args:
      x: (n, d) float32 positions (already divided by lengthscales).
      E: (d+1, d) elevation matrix from :func:`build_rotation`.

    Returns:
      keys: (n, d+1, d) int32 lattice coordinates of the d+1 simplex vertices
        (only the first d coordinates are stored; they sum to 0 with the last).
      weights: (n, d+1) float32 barycentric weights per vertex.
    """
    n, d = x.shape
    dp1 = d + 1
    # Full f32: the elevation decides which simplex each point lands in, and
    # a TF32 product (10 mantissa bits) moves points across simplex faces.
    elevated = jnp.matmul(x, E.T, precision=jax.lax.Precision.HIGHEST)  # (n, d+1)

    # Round to the nearest remainder-0 lattice point (permutohedral.h:409-423).
    scale = 1.0 / dp1
    v = elevated * scale
    up = jnp.ceil(v)
    down = jnp.floor(v)
    pick_up = (up * dp1 - elevated) < (elevated - down * dp1)
    greedy_div = jnp.where(pick_up, up, down).astype(jnp.int32)  # coords / (d+1)
    coord_sum = greedy_div.sum(axis=-1)  # (n,)

    # Rank differential -> permutation w.r.t. the canonical simplex
    # (permutohedral.h:425-433): rank[i] = #{j beating i}, ties broken by index.
    diff = elevated - greedy_div.astype(elevated.dtype) * dp1
    di = diff[:, :, None]
    dj = diff[:, None, :]
    idx = jnp.arange(dp1)
    beats = (dj > di) | ((dj == di) & (idx[None, :] < idx[:, None]))
    rank = beats.sum(axis=-1).astype(jnp.int32)  # (n, d+1)

    # Off-hyperplane repair (permutohedral.h:435-457): shift coordinates so
    # they sum to zero, keeping ranks in [0, d].
    r2 = rank + coord_sum[:, None]
    too_hi = (r2 > d).astype(jnp.int32)
    too_lo = (r2 < 0).astype(jnp.int32)
    greedy_div = greedy_div - too_hi + too_lo
    rank = r2 - dp1 * too_hi + dp1 * too_lo
    greedy = greedy_div * dp1

    # Barycentric coordinates (permutohedral.h:459-465).
    t = (elevated - greedy.astype(elevated.dtype)) * scale  # (n, d+1)
    slots = jnp.arange(d + 2)
    plus = ((d - rank)[:, :, None] == slots) * t[:, :, None]
    minus = ((d + 1 - rank)[:, :, None] == slots) * t[:, :, None]
    bary = (plus - minus).sum(axis=1)  # (n, d+2)
    bary = bary.at[:, 0].add(1.0 + bary[:, d + 1])
    weights = bary[:, : d + 1]

    # Vertex keys (permutohedral.h:468-471): greedy + canonical[remainder][rank].
    can = jnp.asarray(_canonical_simplex(d))  # (d+1, d+1)
    can_sel = can[:, rank[:, :d]]  # (d+1 remainders, n, d)
    keys = greedy[:, None, :d] + jnp.transpose(can_sel, (1, 0, 2))  # (n, d+1, d)
    return keys, weights


def _hash_vectors(d: int, seed: int = 0x5171) -> np.ndarray:
    """Two independent odd int32 multiplier vectors for multiply-shift hashing."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(2, d), dtype=np.uint32) | 1
    return a.view(np.int32)


def _hash_pair(flat: jax.Array, a: np.ndarray):
    """Linear pair hash of int32 key rows: h_j = sum_i a_ji * k_i (mod 2^32).

    All arithmetic is int32 with two's-complement wraparound (XLA semantics),
    i.e. exact mod-2^32.  LINEARITY is the load-bearing property: the hash of
    a neighbor key (key + offset) is hash(key) + hash(offset), so the blur's
    neighbor lookups never touch the d-dimensional keys at all.
    """
    a32 = jnp.asarray(a, jnp.int32)
    h1 = (flat * a32[0]).sum(-1)
    h2 = (flat * a32[1]).sum(-1)
    return h1, h2


def _pair_searchsorted(s1: jax.Array, s2: jax.Array, q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Exact-match indices of hash pairs (q1, q2) in the pair-sorted (s1, s2).

    Returns M (one-past-end) where absent.  A ``lax.fori_loop`` binary
    search: the traced graph is O(1) in M, d, and query count.

    NOTE: kept as the differential-test oracle for :func:`_pair_join`.  Each
    search step is a per-query random gather; the production path is the
    gather-free sort-join below (gather vs sort cost on the H100: not
    measured yet).
    """
    M = s1.shape[0]
    steps = max(1, int(M).bit_length())

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        m1 = s1[mid]
        m2 = s2[mid]
        go_right = (m1 < q1) | ((m1 == q1) & (m2 < q2))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    lo0 = jnp.zeros(q1.shape, dtype=jnp.int32)
    hi0 = jnp.full(q1.shape, M, dtype=jnp.int32)
    lo, _ = jax.lax.fori_loop(0, steps, body, (lo0, hi0))
    cand = jnp.minimum(lo, M - 1)
    match = (s1[cand] == q1) & (s2[cand] == q2) & (lo < M)
    return jnp.where(match, cand, M).astype(jnp.int32)


def _pair_join(u1: jax.Array, u2: jax.Array, q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Exact-match indices of (q1, q2) in the pair-sorted unique (u1, u2).

    Returns M (one-past-end) where absent.  Sort-based hash join: ONE
    ``lax.sort`` of [table; queries] + cumulative maxima -- zero random
    gathers.  Replaces the reference's per-query hash-table probes
    (permutohedral_cuda_kernel.cu:173-201).

    Correctness hinges on two invariants of the sorted concatenation:
      * rows with equal hash pairs are contiguous (a "group"), and the
        table row -- unique by construction -- sorts FIRST in its group
        because its tag (< M) is below every query tag (>= M);
      * table rows keep their relative order, so "index of the most recent
        table row" is a running maximum.
    """
    M = u1.shape[0]
    Q = q1.shape[0]
    h1 = jnp.concatenate([u1, q1])
    h2 = jnp.concatenate([u2, q2])
    tag = jnp.arange(M + Q, dtype=jnp.int32)  # table: 0..M-1, queries: M..M+Q-1
    h1s, h2s, tags = jax.lax.sort((h1, h2, tag), num_keys=3)

    pos = jnp.arange(M + Q, dtype=jnp.int32)
    is_table = tags < M
    new_group = jnp.concatenate(
        [jnp.ones((1,), bool), (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1])]
    )
    group_start = jax.lax.cummax(jnp.where(new_group, pos, -1))
    table_pos = jax.lax.cummax(jnp.where(is_table, pos, -1))
    table_idx = jax.lax.cummax(jnp.where(is_table, tags, -1))
    matched = table_pos >= group_start  # my group's first row is a table row
    res = jnp.where(matched & ~is_table, table_idx, M).astype(jnp.int32)

    # Un-sort results back to query-slot order.  A second 2-operand sort
    # instead of a scatter; table rows get key -1 so they sort to the front
    # and are sliced away.
    slot = jnp.where(is_table, -1, tags - M)
    res_by_slot = jax.lax.sort((slot, res), num_keys=1)[1]
    return res_by_slot[M:]


def _axis_offsets(d: int, order: int) -> np.ndarray:
    """Neighbor key offsets: (d+1 axes, 2*order taps, d coords).

    Along lattice axis j, the neighbor at signed distance t has key
    ``key - t`` in every stored coordinate except coordinate j, which gets
    ``key[j] + t*d`` (permutohedral.h:539-541; axis j == d touches only the
    implicit last coordinate, so all stored coords get -t).
    """
    taps = [t for t in range(-order, order + 1) if t != 0]
    off = np.zeros((d + 1, len(taps), d), dtype=np.int32)
    for j in range(d + 1):
        for ti, t in enumerate(taps):
            off[j, ti, :] = -t
            if j < d:
                off[j, ti, j] = t * d
    return off


class LatticePlan(NamedTuple):
    """Position-dependent, value-independent filter state, reusable across MVMs.

    Shapes: n points, d input dims, M = n*(d+1) lattice capacity, r = order.
      seg_ids:   (n, d+1) int32   lattice-point id of each splat target
      weights:   (n, d+1) float32 barycentric splat/slice weights
      neighbors: (d+1, M, 2r) int32 blur gather indices (M == missing -> zero)
      n_lattice: () int32         number of occupied lattice points (<= M)
    """

    seg_ids: jax.Array
    weights: jax.Array
    neighbors: jax.Array
    n_lattice: jax.Array


def _point_hashes(x: jax.Array, E: jax.Array, a: np.ndarray):
    """Per-point lattice geometry reduced to hash pairs: (h1, h2, weights).

    h1/h2 are (n*(d+1),) int32 linear hashes of the simplex-vertex keys;
    weights are the (n, d+1) barycentric splat weights.  This is the only
    position-dependent, O(n) part of plan construction -- the distributed
    builder (parallel/shard_filter.py) computes it per shard and all-gathers
    just these hashes.
    """
    n, d = x.shape
    keys, weights = lattice_simplex(x.astype(jnp.float32), E)
    h1, h2 = _hash_pair(keys.reshape(n * (d + 1), d), a)
    return h1, h2, weights


# Element budget for per-point geometry transients, which are O(n d^2)
# floats (rank comparisons, vertex keys: n*(d+1)*(d+2) elements each, a few
# alive at once -- ~5 GB at houseelectric scale if unblocked).  The row block
# is sized so each transient stays ~1 GB; low-d/large-n inputs (precipitation:
# n=628k, d=3) then run UNBLOCKED, avoiding lax.map's sequential passes.
# Untuned on the H100.
_GEOMETRY_BLOCK_ELEMS = 256 * 1024 * 1024


def _geometry_hs(x: jax.Array, E: jax.Array, a: np.ndarray):
    """(h1, h2, s, weights) for the chain builder, block-chunked for large n.

    Only the O(n d) reductions of the geometry survive (hash pair +
    coordinate sum per vertex, barycentric weights per point); the O(n d^2)
    intermediates (elevation products, rank comparisons, vertex keys) live
    one block at a time.
    """
    n, d = x.shape
    dp1 = d + 1
    B = max(8192, _GEOMETRY_BLOCK_ELEMS // (dp1 * (d + 2)))

    def block(xb):
        nb = xb.shape[0]
        keys, w = lattice_simplex(xb.astype(jnp.float32), E)
        flat = keys.reshape(nb * dp1, d)
        h1, h2 = _hash_pair(flat, a)
        return h1, h2, flat.sum(-1), w

    if n <= B:
        return block(x)

    n_main = (n // B) * B
    h1m, h2m, sm, wm = jax.lax.map(block, x[:n_main].reshape(n_main // B, B, d))
    parts = [(h1m.reshape(-1), h2m.reshape(-1), sm.reshape(-1), wm.reshape(n_main, dp1))]
    if n_main < n:
        parts.append(block(x[n_main:]))
    h1 = jnp.concatenate([p[0] for p in parts])
    h2 = jnp.concatenate([p[1] for p in parts])
    s = jnp.concatenate([p[2] for p in parts])
    weights = jnp.concatenate([p[3] for p in parts], axis=0)
    return h1, h2, s, weights


def _plan_tables(h1: jax.Array, h2: jax.Array, d: int, order: int, a: np.ndarray):
    """Dedup + neighbor tables from the full set of vertex hashes.

    Returns (seg_ids (N,), neighbors (d+1, N, 2r), n_lattice).  Pure function
    of the hash arrays: replicated across shards in the distributed path.
    """
    N = h1.shape[0]
    dp1 = d + 1

    # Sort-based dedup on a PAIR of linear int32 hashes instead of the
    # d-dimensional keys: a sort's compile and run time grow with its
    # operand count.  With a 64-bit hash
    # pair, dedup/neighbor false positives have probability ~N^2/2^64
    # (~5e-9 at houseelectric scale) -- the same standard the reference's
    # GPU hash table meets with open addressing + key compare.
    idx = jnp.arange(N, dtype=jnp.int32)
    h1s, h2s, perm = jax.lax.sort((h1, h2, idx), num_keys=2)
    is_new = ((h1s != jnp.roll(h1s, 1)) | (h2s != jnp.roll(h2s, 1))).at[0].set(True)
    seg_sorted = (jnp.cumsum(is_new) - 1).astype(jnp.int32)
    n_lattice = seg_sorted[-1] + 1
    seg_ids = jnp.zeros((N,), dtype=jnp.int32).at[perm].set(seg_sorted)
    u1 = jnp.full((N,), _KEY_SENTINEL, dtype=jnp.int32).at[seg_sorted].set(h1s)
    u2 = jnp.full((N,), _KEY_SENTINEL, dtype=jnp.int32).at[seg_sorted].set(h2s)

    # Blur gather indices.  Neighbor hash = point hash + offset hash (hash
    # linearity), so the d-dimensional keys are never touched.
    offsets = _axis_offsets(d, order).astype(np.int64)  # (d+1, 2r, d), taps -r..-1,1..r
    a64 = a.astype(np.int64)
    wrap = lambda h: ((h & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    oh1 = jnp.asarray(wrap((offsets * a64[0]).sum(-1)))  # (d+1, 2r)
    oh2 = jnp.asarray(wrap((offsets * a64[1]).sum(-1)))

    if N * (1 + dp1 * 2 * order) <= _FUSED_JOIN_MAX_ROWS:
        # One join for every (axis, tap) query at once: a single big sort
        # beats d+1 sequential small ones (fixed per-sort pass overheads).
        q1 = (u1[None, None, :] + oh1[:, :, None]).reshape(-1)
        q2 = (u2[None, None, :] + oh2[:, :, None]).reshape(-1)
        neighbors = _pair_join(u1, u2, q1, q2).reshape(dp1, 2 * order, N)
    else:
        # Houseelectric-scale M (~25M rows) cannot hold all axes' queries at
        # once; join one lattice axis at a time under lax.map.
        def axis_neighbors(oh):
            o1, o2 = oh  # (2r,) offset hashes for one axis
            q1 = (u1[None, :] + o1[:, None]).reshape(-1)
            q2 = (u2[None, :] + o2[:, None]).reshape(-1)
            return _pair_join(u1, u2, q1, q2).reshape(2 * order, N)

        neighbors = jax.lax.map(axis_neighbors, (oh1, oh2))
    neighbors = jnp.transpose(neighbors, (0, 2, 1))  # (d+1, M, 2r)
    return seg_ids, neighbors, n_lattice


@functools.partial(jax.jit, static_argnames=("coeffs", "blur_variance"))
def build_plan_join(x: jax.Array, coeffs: tuple, blur_variance: float) -> LatticePlan:
    """Build the gather-based (join) filter plan for positions ``x`` (n, d).

    Replaces the reference hash-table construction (splat side) and the
    per-MVM neighbor hashing of the blur with one dedup sort + one sort-join.

    This is the fallback/backstop engine: the default plan is the sort-chain
    plan (:func:`build_plan_chain`).  The join
    plan remains the engine of record for (a) the data-sharded filter
    (parallel/shard_filter.py), (b) very wide value matrices (its gathers are
    column-count-independent, while chain transition sorts carry every value
    column as a sort operand), and (c) differential testing.
    """
    n, d = x.shape
    dp1 = d + 1
    order = (len(coeffs) - 1) // 2
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)
    h1, h2, weights = _point_hashes(x, E, a)
    seg_ids, neighbors, n_lattice = _plan_tables(h1, h2, d, order, a)
    return LatticePlan(
        seg_ids=seg_ids.reshape(n, dp1),
        weights=weights,
        neighbors=neighbors,
        n_lattice=n_lattice,
    )


@functools.partial(jax.jit, static_argnames=("coeffs", "axis_name"))
def apply_plan_join(
    plan: LatticePlan, v: jax.Array, coeffs: tuple, axis_name: Optional[str] = None
) -> jax.Array:
    """Apply the lattice kernel operator: out ~= K(x, x) @ v, for v (n, c).

    splat (segment_sum) -> d+1 axis blurs (gather + taps) -> slice (gather).
    Linear and exactly symmetric in v by construction (S^T B S with
    symmetric taps), so the VJP w.r.t. v is the same operator.

    With ``axis_name`` (inside shard_map over the data axis), ``plan`` is a
    per-shard plan from parallel/shard_filter.py: v holds the shard's rows,
    the lattice table is the GLOBAL shared state, and the per-shard splat
    partial sums combine in ONE psum -- the lattice analogue of the
    KV ring in ring attention (SURVEY.md section 5).  Blur runs replicated
    (it is O(M), not O(n)); slice reads back only local rows.
    """
    n, dp1 = plan.seg_ids.shape
    d = dp1 - 1
    M = plan.neighbors.shape[1]
    order = plan.neighbors.shape[2] // 2
    taps = [float(c) for c in np.asarray(coeffs)]
    assert len(taps) == 2 * order + 1

    v = v.astype(jnp.float32)
    c_in = v.shape[-1]

    # Splat: scatter-add barycentric-weighted values into the lattice table.
    contrib = (v[:, None, :] * plan.weights[:, :, None]).reshape(n * dp1, c_in)
    table = jax.ops.segment_sum(contrib, plan.seg_ids.reshape(-1), num_segments=M)
    if axis_name is not None:
        # Combine shard-partial tables AND column-split the blur (see
        # apply_plan_chain): each device receives + blurs c/P columns.
        psize = jax.lax.axis_size(axis_name)
        c_pad = -(-c_in // psize) * psize
        if c_pad != c_in:
            table = jnp.concatenate(
                [table, jnp.zeros((M, c_pad - c_in), jnp.float32)], axis=1
            )
        table = jax.lax.psum_scatter(table, axis_name, scatter_dimension=1, tiled=True)

    # Blur: d+1 sequential banded passes along the lattice axes.
    c = table.shape[1]
    tap_list = [t for t in range(-order, order + 1) if t != 0]
    for j in range(dp1):
        padded = jnp.concatenate([table, jnp.zeros((1, c), table.dtype)], axis=0)
        acc = taps[order] * table
        for ti, t in enumerate(tap_list):
            acc = acc + taps[t + order] * padded[plan.neighbors[j, :, ti]]
        table = acc

    if axis_name is not None:
        table = jax.lax.all_gather(table, axis_name, axis=1, tiled=True)[:, :c_in]

    # Slice: replay the splat weights against the blurred table.
    gathered = table[plan.seg_ids]  # (n, d+1, c)
    out = (gathered * plan.weights[:, :, None]).sum(axis=1)
    return out * SLICE_NORM(d)


def filter_once(
    src: jax.Array,
    ref: jax.Array,
    coeffs: tuple,
    blur_variance: float,
    capacity: Optional[int] = None,
) -> jax.Array:
    """One-shot filter(src, ref, coeffs): fused build+apply.

    Mirrors the reference entry point ``filter`` (cpp/lattice.cpp:6-16) for
    callers whose positions change every call (e.g. the rectangular
    cross-covariance MVM).  ``capacity`` as in :func:`build_plan_chain`.
    Dispatches to :func:`filter_fused`, which is 25-40% faster than
    build_plan_chain + apply_plan_chain for single-shot use (see its
    docstring); the split path remains the engine for plan REUSE (CG/SLQ).
    """
    return filter_fused(src, ref, coeffs, blur_variance, capacity=capacity)


# ---------------------------------------------------------------------------
# Sort-chain plan: the default engine.
#
# The join plan's blur needs (d+1) * 2r random row gathers over the (M, c)
# lattice table per MVM.  The chain plan instead re-orders the WHOLE lattice
# table so that, one axis at a time, along-axis neighbors are ADJACENT ROWS
# (it was designed for a machine whose random gathers were slow and whose
# sorts were fast; on the H100 which engine wins is not measured yet):
#
#   * every lattice axis j decomposes the lattice into disjoint 1-D chains
#     {key + t*o_j}; sorting lattice points by (chain-invariant hash of axis
#     j, coordinate-sum s) puts each chain's points in consecutive rows in
#     chain order -- the blur along axis j becomes a (2r+1)-tap SHIFT stencil
#     (elementwise, fused by XLA);
#   * moving the table from axis-j order to axis-(j+1) order is ONE
#     2-key lax.sort whose keys are precomputed at plan-build time;
#   * splat: contributions are sorted once by a precomputed destination
#     permutation, then segment sums fall out of a cumulative sum and a
#     boundary difference (replacing a scatter-add segment_sum);
#   * slice: one gather of the final-order table (replay).
#
# Per MVM: d sorts + 1 gather + elementwise work, vs the join plan's
# (d+1)*2r gathers + scatter-add.
#
# Plan build exploits the same trick as the join plan (hash linearity:
# chain-invariant hash = s(o_j)*h(key) - s(key)*h(o_j)), and computes ALL
# transition keys in ONE batched sort by carrying the next axis's chain keys
# as sort payloads -- no rank/permutation-composition passes and no
# (d+1)*2r*M-row neighbor join.
#
# Replaces: hash-table blur neighbor walk (permutohedral_cuda_kernel.cu
# :359-398) and scatter-add splat (:335-356).
# ---------------------------------------------------------------------------

# s (the coordinate sum, the position-along-chain parameter) is packed into
# the low 21 bits of the second chain-hash word; the surviving top 11 bits
# still contribute to chain identification (43 hash bits total; expected
# false chain merges at houseelectric scale ~1e-3 of lattice points, far
# below the filter's intrinsic discretization error).
_S_BITS = 21
_S_BIAS = np.int32(1 << 20)
_S_MASK = np.int32((1 << _S_BITS) - 1)
_TOP_MASK = np.int32(-(1 << _S_BITS))  # ~_S_MASK
_PAD_H1 = np.int32(0x7FFFFFF1)
_PAD_H2 = np.int32(0x7FFFFFF2)


def _axis_dir(d: int):
    """Along-axis +1-tap key offset per lattice axis and its coordinate sum.

    Axis j < d: stored coordinate j moves by +d, all others by -1 (coordinate
    sum +1).  Axis d (the implicit coordinate): all stored coordinates move
    by -1 (coordinate sum -d).  Same geometry as permutohedral.h:539-541.
    """
    off = np.full((d + 1, d), -1, dtype=np.int64)
    for j in range(d):
        off[j, j] = d
    return off, off.sum(-1)  # (d+1, d), (d+1,)


class ChainPlan(NamedTuple):
    """Sort-chain filter plan.  Shapes: n points, d dims, M = n*(d+1) rows,
    r = order.

      dest:      (n*(d+1),) int32  splat sort key: contribution -> position
      cnt:       (M,) int32        cumulative #contributions per table row
      k1, k2:    (d, M) int32      transition sort keys, axis j -> j+1 order
      tapw:      (d+1, r, M) f32   forward tap weights at sorted offset k
      slice_idx: (n*(d+1),) int32  final-order table row per simplex vertex
      weights:   (n*(d+1),) f32    barycentric splat/slice weights
      n_lattice: () int32          occupied lattice points (<= M)

    ``slice_idx``/``weights`` are stored FLAT in vertex-major order, so the
    slice's vertex reduction is d+1 contiguous n-row slices.
    """

    dest: jax.Array
    cnt: jax.Array
    k1: jax.Array
    k2: jax.Array
    tapw: jax.Array
    slice_idx: jax.Array
    weights: jax.Array
    n_lattice: jax.Array


def _pack(c2: jax.Array, s: jax.Array) -> jax.Array:
    """Pack (top 11 bits of chain word c2, coordinate sum s) into one int32.

    Within a chain the top bits agree, so int32 ordering of the packed word
    is ordering by s -- one sort key does grouping AND chain positioning.
    """
    sb = jnp.clip(s + _S_BIAS, 0, _S_MASK)
    return (c2 & _TOP_MASK) | sb


def _chain_words(h1, h2, s, axes: np.ndarray, d: int):
    """Chain-invariant hash pair for each axis in ``axes``: (|axes|, V) x2.

    For axis direction o, c(key) = s(o)*h(key) - s(key)*h(o) is constant
    along the chain {key + t*o} by hash linearity (mod 2^32), and separates
    chains like any 64-bit hash.  The d-dimensional keys are never touched.
    """
    off, so = _axis_dir(d)
    a = _hash_vectors(d).astype(np.int64)
    wrap = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    oh1 = jnp.asarray(wrap((off[axes] * a[0]).sum(-1)))  # (|axes|,)
    oh2 = jnp.asarray(wrap((off[axes] * a[1]).sum(-1)))
    mult = jnp.asarray(so[axes].astype(np.int32))
    c1 = mult[:, None] * h1[None, :] - s[None, :] * oh1[:, None]
    c2 = mult[:, None] * h2[None, :] - s[None, :] * oh2[:, None]
    return c1, c2


def _axis_tap_weights(c1s, c2ps, step: int, order: int, taps):
    """Forward tap weights from an axis's sorted chain keys: (..., r, M) f32.

    ``out[..., k-1, p]`` is the blur coefficient linking sorted rows p and
    p+k.  A chain may be sparsely occupied, so the distance-t tap partner of
    a row can sit at ANY sorted offset k <= t; the pair's true chain distance
    is recovered from the coordinate-sum difference (packed-s diff == t*step
    selects tap t; at most one t matches since s is strictly monotone along a
    chain).  Rows of different chains (unequal chain-hash words) get weight
    0.  Padding rows share a sentinel chain word and s == 0, so they never
    pass the s test against each other, and never match a real chain (up to
    hash collision).
    """
    s_lo = c2ps & _S_MASK
    top = c2ps & _TOP_MASK
    rows = []
    for k in range(1, order + 1):
        same = (c1s[..., k:] == c1s[..., :-k]) & (top[..., k:] == top[..., :-k])
        ds = s_lo[..., k:] - s_lo[..., :-k]
        w = jnp.zeros(ds.shape, jnp.float32)
        for t in range(k, order + 1):
            w = jnp.where(same & (ds == t * step), np.float32(taps[order + t]), w)
        pad = jnp.zeros(w.shape[:-1] + (k,), jnp.float32)
        rows.append(jnp.concatenate([w, pad], axis=-1))
    return jnp.stack(rows, axis=-2)  # (..., r, M)


def _chain_core(h1: jax.Array, h2: jax.Array, s: jax.Array, d: int, order: int, cs,
                capacity: Optional[int] = None):
    """Global chain tables from the full set of vertex (hash-pair, coord-sum).

    Pure function of the hash/coordinate-sum arrays: the distributed builder
    (parallel/shard_filter.py) all-gathers just these 12 bytes/vertex and
    every shard deterministically computes IDENTICAL global tables.

    Returns (dest, seg_orig, cnt, k1, k2, tapw, rank_d, n_lattice); shapes as
    in :class:`ChainPlan`, with table capacity M = len(h1).

    ``capacity`` statically trims the table to fewer rows than the worst-case
    M = n*(d+1): real datasets occupy only ~25-40% of the bound (vertex
    sharing), and every per-row array (cnt/k1/k2/tapw) plus every build and
    apply sort shrinks proportionally.  The caller MUST ensure
    capacity >= n_lattice (measure once with count_lattice_points); the
    returned n_lattice makes violations detectable after the fact.
    """
    M = h1.shape[0]
    iota = jnp.arange(M, dtype=jnp.int32)

    # ---- fused dedup + axis-0 chain sort over contributions -------------
    # h1 is NOT carried as a payload: the axis-0 chain-word multiplier is 1
    # (_axis_dir: coordinate-sum step of axes j < d is +1), so
    # c1 = h1 - s*oh1 inverts to h1 = c1 + s*oh1 exactly (int32 wraparound).
    c1_0, c2_0 = _chain_words(h1, h2, s, np.array([0]), d)
    k0 = _pack(c2_0[0], s)
    C1, K0, I, H2 = jax.lax.sort((c1_0[0], k0, iota, h2), num_keys=2)
    # (chain word, packed s) identifies the point; H2 refines dedup back to
    # ~64 hash bits.  (A (C1, K0) collision between two distinct points can
    # split one point across table rows -- bounded, vanishing-probability
    # discretization noise, same standard as the reference's GPU hash table.)
    newgrp = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (C1[1:] != C1[:-1]) | (K0[1:] != K0[:-1]) | (H2[1:] != H2[:-1]),
        ]
    )
    seg_sorted = (jnp.cumsum(newgrp) - 1).astype(jnp.int32)
    n_lattice = seg_sorted[-1] + 1
    Mc = M if capacity is None else min(capacity, M)
    iota_c = iota[:Mc]

    # Per-contribution destination (and compact segment id) in input order.
    _, dest, seg_orig = jax.lax.sort((I, iota, seg_sorted), num_keys=1)

    # ONE compaction pass yields the unique-point table (group-first rows,
    # in axis-0 chain order) AND, via the group-first *positions*, the
    # cumulative contribution counts: group g's contributions end where
    # group g+1 starts, so cnt[g] = u_pos[g+1] (and M for the last live
    # group and all padding rows).  Heavily trimmed tables use the binary-
    # search compaction (see _leader_positions); otherwise a full-M sort
    # pulls the leaders to the front.
    if Mc <= _COMPACT_SEARCH_MAX_MC and M >= _COMPACT_SEARCH_MIN_RATIO * Mc:
        u_pos = _leader_positions(seg_sorted, Mc, M)
        at = jnp.minimum(u_pos, M - 1)
        u_c1, u_h2, u_k0 = C1[at], H2[at], K0[at]
    else:
        _, u_pos, u_c1, u_h2, u_k0 = jax.lax.sort(
            (jnp.where(newgrp, seg_sorted, M + iota), iota, C1, H2, K0), num_keys=1
        )
        u_pos, u_c1, u_h2, u_k0 = u_pos[:Mc], u_c1[:Mc], u_h2[:Mc], u_k0[:Mc]
    u_pos_next = jnp.concatenate([u_pos[1:], jnp.full((1,), M, jnp.int32)])
    cnt = jnp.where(iota_c + 1 < n_lattice, u_pos_next, M).astype(jnp.int32)

    live = iota_c < n_lattice
    u_s = jnp.where(live, (u_k0 & _S_MASK) - _S_BIAS, 0)
    off0, _ = _axis_dir(d)
    a64 = _hash_vectors(d).astype(np.int64)
    oh1_0 = int((np.asarray([(off0[0] * a64[0]).sum()]) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)[0])
    u_h1 = jnp.where(live, u_c1 + u_s * oh1_0, _PAD_H1)
    u_h2 = jnp.where(live, u_h2, _PAD_H2)

    # tapw[0]: adjacency weights in the table's own (axis-0) order.
    c1u, c2u = _chain_words(u_h1, u_h2, u_s, np.array([0]), d)
    m0 = _axis_tap_weights(c1u[0], _pack(c2u[0], u_s), 1, order, cs)

    # ---- final axis: direct sort + rank (exact final positions) ---------
    c1d, c2d = _chain_words(u_h1, u_h2, u_s, np.array([d]), d)
    C1d, C2pd, perm_d = jax.lax.sort((c1d[0], _pack(c2d[0], u_s), iota_c), num_keys=2)
    rank_d = jax.lax.sort((perm_d, iota_c), num_keys=1)[1]
    md = _axis_tap_weights(C1d, C2pd, d, order, cs)

    if d >= 2 and (d - 1) * Mc <= _FUSED_BUILD_MAX_ROWS:
        # ---- axes 1..d-1, ONE batched sort ------------------------------
        # Keys: axis-j chain words.  Payloads: axis-(j+1) chain words (for
        # j < d-1) or rank_d (for j = d-1).  The sorted payloads ARE the
        # apply-time transition keys: at position p of axis-j order they hold
        # the next axis's key of that row, so sorting the table by them moves
        # it into axis-(j+1) order.  The last transition sorts by exact final
        # positions (rank_d), which also makes slice_idx's tie-handling exact.
        c1m, c2m = _chain_words(u_h1, u_h2, u_s, np.arange(1, d), d)
        c2pm = _pack(c2m, u_s[None, :])
        c1n, c2n = _chain_words(u_h1, u_h2, u_s, np.arange(2, d + 1), d)
        c2pn = _pack(c2n, u_s[None, :])
        zrow = jnp.zeros((1, Mc), jnp.int32)
        p1 = jnp.concatenate([c1n[:-1], rank_d[None]], axis=0)
        p2 = jnp.concatenate([c2pn[:-1], zrow], axis=0)
        K1s, K2s, T1, T2 = jax.lax.sort((c1m, c2pm, p1, p2), dimension=1, num_keys=2)
        mmid = _axis_tap_weights(K1s, K2s, 1, order, cs)
        k1 = jnp.concatenate([c1m[:1], T1], axis=0)
        k2 = jnp.concatenate([c2pm[:1], T2], axis=0)
        tapw = jnp.concatenate([m0[None], mmid, md[None]], axis=0)
    elif d >= 2:
        # ---- axes 1..d-1, chunked (houseelectric-scale M) ----------------
        # Identical math to the fused branch, one axis per lax.map step: the
        # fused sort materializes 4 operands of (d-1, M) twice (~8 GB at
        # M=24.6M, d=11); per-axis peak is ~6 (M,) transients.  Plan build
        # runs once per loss eval, so the extra sequential passes cost
        # latency only.  The switch point is untuned on the H100.
        off, so = _axis_dir(d)
        a64 = _hash_vectors(d).astype(np.int64)
        wrap = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
        oh1_all = jnp.asarray(wrap((off * a64[0]).sum(-1)))  # (d+1,)
        oh2_all = jnp.asarray(wrap((off * a64[1]).sum(-1)))
        mult_all = jnp.asarray(so.astype(np.int32))

        def one_axis(j):
            c1j = mult_all[j] * u_h1 - u_s * oh1_all[j]
            c2j = _pack(mult_all[j] * u_h2 - u_s * oh2_all[j], u_s)
            jn = j + 1
            p1j = jnp.where(
                jn == d, rank_d, mult_all[jn] * u_h1 - u_s * oh1_all[jn]
            )
            p2j = jnp.where(
                jn == d,
                jnp.zeros_like(u_s),
                _pack(mult_all[jn] * u_h2 - u_s * oh2_all[jn], u_s),
            )
            K1s, K2s, T1j, T2j = jax.lax.sort((c1j, c2j, p1j, p2j), num_keys=2)
            return T1j, T2j, _axis_tap_weights(K1s, K2s, 1, order, cs)

        T1, T2, mmid = jax.lax.map(one_axis, jnp.arange(1, d, dtype=jnp.int32))
        c1f, c2f = _chain_words(u_h1, u_h2, u_s, np.array([1]), d)
        k1 = jnp.concatenate([c1f, T1], axis=0)
        k2 = jnp.concatenate([_pack(c2f[0], u_s)[None], T2], axis=0)
        tapw = jnp.concatenate([m0[None], mmid, md[None]], axis=0)
    else:
        k1 = rank_d[None]
        k2 = jnp.zeros((1, Mc), jnp.int32)
        tapw = jnp.stack([m0, md], axis=0)

    return dest, seg_orig, cnt, k1, k2, tapw, rank_d, n_lattice


@functools.partial(jax.jit, static_argnames=("coeffs", "blur_variance"))
def count_lattice_points(x: jax.Array, blur_variance: float, coeffs: tuple = (0.5, 1.0, 0.5)) -> jax.Array:
    """Number of occupied lattice points for positions ``x`` (one cheap sort).

    Used to pick a trimmed static ``capacity`` for :func:`build_plan_chain`
    at very large n, where the worst-case bound M = n*(d+1) wastes 3-4x
    memory and sort time (measured occupancy: houseelectric-scale inputs
    ~25-40%).
    """
    _, d = x.shape
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)
    h1, h2, _, _ = _geometry_hs(x, E, a)
    h1s, h2s = jax.lax.sort((h1, h2), num_keys=2)
    is_new = ((h1s != jnp.roll(h1s, 1)) | (h2s != jnp.roll(h2s, 1))).at[0].set(True)
    return is_new.sum()


@functools.partial(jax.jit, static_argnames=("coeffs", "blur_variance", "capacity"))
def build_plan_chain(
    x: jax.Array, coeffs: tuple, blur_variance: float, capacity: Optional[int] = None
) -> ChainPlan:
    """Build the sort-chain filter plan for positions ``x`` (n, d).

    One fused dedup+axis-0 sort over the n*(d+1) simplex vertices, one
    batched sort over axes 1..d-1 (carrying the NEXT axis's chain keys as
    payloads, so the apply-time transition keys come out directly), and two
    small sorts for the final axis.  No scatter, no neighbor join.

    ``capacity`` (static) trims the per-lattice-row tables below the
    worst-case n*(d+1); callers must guarantee capacity >= the occupied
    count (see :func:`count_lattice_points`) and can verify via the
    returned plan's ``n_lattice``.
    """
    cs = np.asarray(coeffs, np.float64)
    if not np.allclose(cs, cs[::-1]):
        raise ValueError("chain plan requires symmetric filter taps")
    n, d = x.shape
    dp1 = d + 1
    order = (len(coeffs) - 1) // 2
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)

    h1, h2, s, weights = _geometry_hs(x, E, a)

    # Vertex-major contribution order (vertex j's block of n rows first):
    # every (n, d+1)-shaped intermediate of the apply becomes (d+1, n), with
    # the long axis minor, and the slice's vertex reduction becomes d+1
    # contiguous n-row slices.
    vm = lambda t: t.reshape(n, dp1).T.reshape(-1)
    h1, h2, s = vm(h1), vm(h2), vm(s)
    dest, seg_orig, cnt, k1, k2, tapw, rank_d, n_lattice = _chain_core(
        h1, h2, s, d, order, cs, capacity=capacity
    )
    slice_idx = rank_d[seg_orig]  # flat vertex-major (n*(d+1),)
    weights = weights.T.reshape(-1)
    return ChainPlan(
        dest=dest,
        cnt=cnt,
        k1=k1,
        k2=k2,
        tapw=tapw,
        slice_idx=slice_idx,
        weights=weights,
        n_lattice=n_lattice,
    )


def _slice_packed(plan, tableT: jax.Array, n: int, dp1: int, d: int, M: int, c_in: int) -> jax.Array:
    """Slice for the packed (c, M) table: one gather + vertex-sum + guard."""
    gathered = tableT[:, plan.slice_idx] * plan.weights[None, :]  # (c, n*dp1)
    out = gathered.reshape(c_in, dp1, n).sum(1).T
    return jnp.where(plan.n_lattice <= M, out * SLICE_NORM(d), jnp.float32(jnp.nan))


def _chain_stencil_1d(t: jax.Array, tapw_j: jax.Array, center: float, order: int) -> jax.Array:
    """1-D column variant of :func:`_chain_stencil` (same math)."""
    acc = center * t
    for k in range(1, order + 1):
        w = tapw_j[k - 1]
        zk = jnp.zeros((k,), t.dtype)
        acc = acc + w * jnp.concatenate([t[k:], zk]) + jnp.concatenate([zk, (w * t)[:-k]])
    return acc


def _chain_stencil(tab: jax.Array, tapw_j: jax.Array, center: float, order: int) -> jax.Array:
    """(2r+1)-tap weighted shift stencil along the current chain order.

    ``tapw_j[k-1, p]`` carries the (already tap-selected) blur coefficient
    between sorted rows p and p+k; the stencil applies it in both directions,
    keeping the per-axis blur operator exactly symmetric.
    """
    c = tab.shape[-1]
    acc = center * tab
    for k in range(1, order + 1):
        w = tapw_j[k - 1][:, None]
        fwd = w * jnp.concatenate([tab[k:], jnp.zeros((k, c), tab.dtype)], axis=0)
        bwd = jnp.concatenate([jnp.zeros((k, c), tab.dtype), (w * tab)[:-k]], axis=0)
        acc = acc + fwd + bwd
    return acc


def _packed_stencil(tab: jax.Array, tapw_j: jax.Array, center: float, order: int) -> jax.Array:
    """(c, M) variant of :func:`_chain_stencil` (same math, long axis minor)."""
    c = tab.shape[0]
    acc = center * tab
    for k in range(1, order + 1):
        w = tapw_j[k - 1][None, :]
        zk = jnp.zeros((c, k), tab.dtype)
        acc = (
            acc
            + w * jnp.concatenate([tab[:, k:], zk], 1)
            + jnp.concatenate([zk, (w * tab)[:, :-k]], 1)
        )
    return acc


def _blur_axes(table, plan: "ChainPlan", stencil, transition):
    """Blur along lattice axes 0..d: ``stencil(table, tapw_j)`` on every axis,
    ``transition(table, k1_j, k2_j)`` (the sort into the next axis's chain
    order) between consecutive axes.

    The d (stencil, transition) steps run under ONE ``lax.scan``, so XLA
    compiles the transition sort once rather than d times.  On the GPU a
    large sort compiles to a chain of bitonic-stage kernels, and d unrolled
    copies of it made the 11-column apply at d = 18 take over 3 minutes to
    compile on an H100.
    """
    d = plan.k1.shape[0]

    def step(t, xs):
        tapw_j, k1_j, k2_j = xs
        return transition(stencil(t, tapw_j), k1_j, k2_j), None

    table, _ = jax.lax.scan(step, table, (plan.tapw[:d], plan.k1, plan.k2))
    return stencil(table, plan.tapw[d])


@functools.partial(jax.jit, static_argnames=("coeffs", "axis_name"))
def apply_plan_chain(
    plan: ChainPlan, v: jax.Array, coeffs: tuple, axis_name: Optional[str] = None
) -> jax.Array:
    """Apply the lattice kernel operator via the sort-chain plan: K(x,x) @ v.

    splat (sort + cumsum + boundary diff) -> d+1 shift stencils with d
    transition sorts -> slice (gather).  Zero gathers in the blur itself.

    With ``axis_name`` (inside shard_map over the data axis), ``plan`` is a
    per-shard plan from parallel/shard_filter.py: v holds this shard's rows,
    dest/cnt route the LOCAL contributions into the GLOBAL table layout, and
    the per-shard partial tables combine over the mesh.  The blur -- the O(M·c)
    dominant cost -- is COLUMN-SPLIT across the mesh: the partial tables
    combine in a psum_scatter over the value columns (each device receives
    the global table for c/P of the columns), every device runs the shift
    stencils + transition sorts on only its column block, and one all_gather
    reassembles the blurred table before the (local-row) slice.  Per-device
    blur work is O(M·c/P) -- it SCALES with the mesh, unlike a replicated
    blur -- at the same communication volume as a plain psum.

    NOTE: every transition sort carries its value columns as payloads; for
    wide v (above ops/filter.py:_WIDE_COLS, currently 16; e.g. the fused
    derivative-coefficient backward filter) use the join plan, whose gather
    cost is column-count-independent.
    """
    dp1 = plan.tapw.shape[0]
    d = dp1 - 1
    Mct = plan.weights.shape[0]  # n*(d+1) contribution rows
    n = Mct // dp1
    M = plan.cnt.shape[0]  # global table capacity
    order = plan.tapw.shape[1]
    taps = [float(t) for t in np.asarray(coeffs)]
    assert len(taps) == 2 * order + 1

    v = v.astype(jnp.float32)
    c_in = v.shape[-1]
    cols = lambda t: tuple(t[:, k] for k in range(t.shape[1]))

    # Layout: large arrays are either 1-D or keep the HUGE axis minor.  The
    # plan's per-contribution arrays are VERTEX-major (see build_plan_chain),
    # so the splat broadcast is (d+1, n) per column, the table travels as a
    # tuple of 1-D columns, the slice gather is (c, rows)-oriented, and the
    # vertex reduction is d+1 contiguous n-row slices.  (These choices were
    # made for a tiled-memory machine and are unrevisited on the H100.)
    W2 = plan.weights.reshape(dp1, n)

    if axis_name is None and c_in > 1:
        # PACKED (c, M) formulation for multi-column applies (the BBMM
        # engine's probes+y block): cumsum/boundary-diff/stencils/slice run
        # on (c, M) arrays with the HUGE axis minor, in ~c x fewer XLA ops
        # than the per-column 1-D formulation.
        # Sort operands stay per-column 1-D: lax.sort requires operand
        # shape == key shape, and broadcasting keys to (c, M) would move
        # c x the key bytes.
        contrib = (W2[None] * v.T[:, None, :]).reshape(c_in, Mct)
        sc = jax.lax.sort(
            (plan.dest,) + tuple(contrib[k] for k in range(c_in)), num_keys=1
        )[1:]
        S = jnp.stack(sc, 0)  # (c, Mct)
        Z = jnp.zeros((c_in, 1), jnp.float32)
        Lk = jnp.concatenate([Z, jnp.cumsum(S, axis=1)], axis=1)[:, plan.cnt]
        table2 = Lk - jnp.concatenate([Z, Lk[:, :-1]], axis=1)  # (c, M)
        table2 = _blur_axes(
            table2,
            plan,
            lambda t, w: _packed_stencil(t, w, taps[order], order),
            lambda t, a, b: jnp.stack(jax.lax.sort((a, b) + tuple(t), num_keys=2)[2:], 0),
        )
        return _slice_packed(plan, table2, n, dp1, d, M, c_in)

    # Splat: route (this shard's) contributions into global-table order,
    # segment-sum by cumulative sum + per-row boundary difference.
    contrib_cols = tuple((W2 * v[:, k][None, :]).reshape(Mct) for k in range(c_in))
    sc = jax.lax.sort((plan.dest,) + contrib_cols, num_keys=1)[1:]
    zero1 = jnp.zeros((1,), jnp.float32)
    tcols = []
    for s in sc:
        Lk = jnp.concatenate([zero1, jnp.cumsum(s)])[plan.cnt]
        tcols.append(Lk - jnp.concatenate([zero1, Lk[:-1]]))
    table = jnp.stack(tcols, axis=-1) if axis_name is not None else tuple(tcols)
    if axis_name is not None:
        # Sharded path: the column-split blur needs a stacked (M, c) table
        # for the psum_scatter/all_gather collectives; per-device column
        # blocks stay narrow.
        psize = jax.lax.axis_size(axis_name)
        c_pad = -(-c_in // psize) * psize
        if c_pad != c_in:
            table = jnp.concatenate(
                [table, jnp.zeros((M, c_pad - c_in), jnp.float32)], axis=1
            )
        # Combine shard-partial tables AND deal each device its column block.
        table = jax.lax.psum_scatter(
            table, axis_name, scatter_dimension=1, tiled=True
        )  # (M, c_pad / P)
        table = _blur_axes(
            table,
            plan,
            lambda t, w: _chain_stencil(t, w, taps[order], order),
            lambda t, a, b: jnp.stack(jax.lax.sort((a, b) + cols(t), num_keys=2)[2:], axis=-1),
        )
        table = jax.lax.all_gather(
            table, axis_name, axis=1, tiled=True
        )[:, :c_in]  # (M, c_in)
        tcols = tuple(table[:, k] for k in range(c_in))
    else:
        # Blur: shift stencil per axis, one transition sort between axes;
        # the table stays a TUPLE of 1-D columns throughout.
        tcols = _blur_axes(
            table,
            plan,
            lambda t, w: tuple(_chain_stencil_1d(x, w, taps[order], order) for x in t),
            lambda t, a, b: tuple(jax.lax.sort((a, b) + t, num_keys=2)[2:]),
        )

    # Slice: replay the splat weights against the final-order table.  ONE
    # (c, n*dp1) gather, so all c values of a lattice row come from a single
    # indexed fetch; the (c, rows) orientation keeps the huge axis minor.
    # The vertex reduction is d+1 CONTIGUOUS n-row slices (vertex-major
    # order).
    tableT = jnp.stack(tcols, axis=0)  # (c, Mc)
    gathered = tableT[:, plan.slice_idx]  # (c, n*dp1)
    out_cols = []
    for k in range(c_in):
        gw = gathered[k] * plan.weights  # (n*dp1,)
        acc = gw[0:n]
        for jj in range(1, dp1):
            acc = acc + gw[jj * n : (jj + 1) * n]
        out_cols.append(acc)
    out = jnp.stack(out_cols, axis=-1)
    # Capacity guard: a trimmed plan (capacity < n_lattice) silently drops
    # lattice rows in _chain_core -- e.g. when lengthscales drift during
    # training and occupancy grows past a capacity measured at init.  Poison
    # the output with NaN instead of returning garbage: NaN propagates to the
    # loss/predictions where every driver sees it immediately.  Costs one
    # scalar compare per apply; always true for untrimmed plans (M >= any
    # occupancy by construction).
    return jnp.where(plan.n_lattice <= M, out * SLICE_NORM(d), jnp.float32(jnp.nan))


# ---------------------------------------------------------------------------
# Fused one-shot filter: the rebuild-every-MVM path, maximally collapsed.
#
# The reference's convention is to rebuild its hash table on EVERY filter
# call (its replay buffer cannot be reused); our benchmark "full MVM" numbers
# follow that convention, so the one-shot path deserves its own fused
# formulation instead of build_plan_chain + apply_plan_chain:
#
#   * the splat VALUES ride the dedup sort as payloads, so the apply-time
#     splat sort and the dest un-sort (2 of the 4 full-M passes) disappear;
#   * transitions sort by FULL-PRECISION per-axis chain words recomputed on
#     the fly (3 int32 keys: c1, c2, raw s) -- no packed 43-bit words, so
#     chain false-merge probability drops from ~2^-43 to ~2^-64 per pair,
#     and no separate build pass producing k1/k2 is needed.  The axis-j
#     chain-word multiplier is 1 for every axis j < d (_axis_dir), so
#     (h1, h2) are recovered EXACTLY from the sorted keys (h = c + s*oh)
#     and only the single transition into axis-d order carries h payloads;
#   * the blur visits axes 0..d in the reference's order, then ONE extra
#     transition returns the table to dedup (axis-0) order, so the slice
#     indexes it directly with the contribution segment ids -- no rank_d
#     inversion, no iota carriage.
#
# Cost for c value columns (M = n*(d+1) contribution rows, Mc = trimmed
# table): (12 + c) full-M sort-operand passes + (4 + c) * (d + 1) + 2
# Mc-row passes, vs build+apply's (13 + c) and ~(7 + c) * d.
# ---------------------------------------------------------------------------


def _axis_hash_consts(d: int):
    """Per-axis (offset-hash1, offset-hash2, coord-sum step) as python ints."""
    off, so = _axis_dir(d)
    a64 = _hash_vectors(d).astype(np.int64)
    wrap = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)
    oh1 = wrap((off * a64[0]).sum(-1))  # (d+1,)
    oh2 = wrap((off * a64[1]).sum(-1))
    return [int(v) for v in oh1], [int(v) for v in oh2], [int(v) for v in so]


def _tapw_full(c1: jax.Array, c2: jax.Array, s: jax.Array, step: int, order: int, cs):
    """Forward tap weights from full-precision sorted chain words: (r, Mc).

    Same contract as :func:`_axis_tap_weights` but chain identity is the full
    64-bit (c1, c2) pair and the chain position is the raw coordinate sum
    ``s`` -- no packing.  Padding rows (s == INT32_MAX) pair with nothing:
    dead-dead pairs have ds == 0 (never a tap) and dead-live pairs differ in
    c1 (pinned to INT32_MAX) up to a ~2^-64 collision.
    """
    rows = []
    for k in range(1, order + 1):
        same = (c1[k:] == c1[:-k]) & (c2[k:] == c2[:-k])
        ds = s[k:] - s[:-k]
        w = jnp.zeros(ds.shape, jnp.float32)
        for t in range(k, order + 1):
            w = jnp.where(same & (ds == t * step), np.float32(cs[order + t]), w)
        rows.append(jnp.concatenate([w, jnp.zeros((k,), jnp.float32)]))
    return jnp.stack(rows, axis=0)  # (r, Mc)


_INT32_MAX = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("coeffs", "blur_variance", "capacity"))
def filter_fused(
    src: jax.Array,
    x: jax.Array,
    coeffs: tuple,
    blur_variance: float,
    capacity: Optional[int] = None,
) -> jax.Array:
    """Fused one-shot lattice filter: out ~= K(x, x) @ src, src (n, c).

    See the section comment above for the design.  Applies the same operator
    as ``apply_plan_chain(build_plan_chain(x, ...), src, ...)`` (identical
    axis order and summation order), differing only under 64-bit hash
    collisions.  ``capacity`` trims the lattice table as in
    :func:`build_plan_chain`; an undersized capacity poisons the output with
    NaN (same guard as apply_plan_chain).
    """
    cs = np.asarray(coeffs, np.float64)
    if not np.allclose(cs, cs[::-1]):
        raise ValueError("fused filter requires symmetric filter taps")
    n, d = x.shape
    dp1 = d + 1
    order = (len(coeffs) - 1) // 2
    center = float(cs[order])
    E = jnp.asarray(build_rotation(d, blur_variance))
    a = _hash_vectors(d)
    oh1, oh2, mult = _axis_hash_consts(d)

    h1, h2, s, weights = _geometry_hs(x, E, a)
    M = n * dp1
    # Vertex-major contribution order + per-column 1-D pipelines: layout
    # discipline as in build_plan_chain/apply_plan_chain.
    vmi = lambda t: t.reshape(n, dp1).T.reshape(-1)
    h1, h2, s = vmi(h1), vmi(h2), vmi(s)
    W2 = weights.T  # (dp1, n)
    weights = W2.reshape(-1)
    Mc = M if capacity is None else min(capacity, M)
    v = src.astype(jnp.float32)
    c_in = v.shape[-1]
    iota = jnp.arange(M, dtype=jnp.int32)
    contrib_cols = tuple((W2 * v[:, k][None, :]).reshape(M) for k in range(c_in))

    # Dedup sort in axis-0 chain order, values riding as payloads.
    c1_0 = mult[0] * h1 - s * oh1[0]
    c2_0 = mult[0] * h2 - s * oh2[0]
    srt = jax.lax.sort((c1_0, c2_0, s, iota) + contrib_cols, num_keys=3)
    C1, C2, S, I = srt[0], srt[1], srt[2], srt[3]
    CV_cols = srt[4:]  # c 1-D columns, contributions in table order
    newgrp = jnp.concatenate(
        [jnp.ones((1,), bool), (C1[1:] != C1[:-1]) | (C2[1:] != C2[:-1]) | (S[1:] != S[:-1])]
    )
    seg_sorted = (jnp.cumsum(newgrp) - 1).astype(jnp.int32)
    n_lattice = seg_sorted[-1] + 1

    # Compact group leaders into the (trimmed) table; cnt = cumulative
    # contribution counts per row (group g ends where group g+1 starts).
    # Binary-search compaction when heavily trimmed (see _leader_positions).
    if Mc <= _COMPACT_SEARCH_MAX_MC and M >= _COMPACT_SEARCH_MIN_RATIO * Mc:
        u_pos = _leader_positions(seg_sorted, Mc, M)
        at = jnp.minimum(u_pos, M - 1)
        u_c1, u_c2, u_s = C1[at], C2[at], S[at]
    else:
        _, u_pos, u_c1, u_c2, u_s = jax.lax.sort(
            (jnp.where(newgrp, seg_sorted, M + iota), iota, C1, C2, S), num_keys=1
        )
        u_pos, u_c1, u_c2, u_s = u_pos[:Mc], u_c1[:Mc], u_c2[:Mc], u_s[:Mc]
    iota_c = jnp.arange(Mc, dtype=jnp.int32)
    live = iota_c < n_lattice
    u_c1 = jnp.where(live, u_c1, _INT32_MAX)
    u_c2 = jnp.where(live, u_c2, _INT32_MAX)
    u_s = jnp.where(live, u_s, _INT32_MAX)
    u_pos_next = jnp.concatenate([u_pos[1:], jnp.full((1,), M, jnp.int32)])
    cnt = jnp.where(iota_c + 1 < n_lattice, u_pos_next, M)

    # Splat: per-group sums from boundary diffs of the contribution cumsum
    # (per-column 1-D, as in apply_plan_chain).
    zero1 = jnp.zeros((1,), jnp.float32)
    tcols = []
    for cv in CV_cols:
        Lk = jnp.concatenate([zero1, jnp.cumsum(cv)])[cnt]
        tcols.append(Lk - jnp.concatenate([zero1, Lk[:-1]]))
    tcols = tuple(tcols)

    # Blur axes 0..d (reference order), then transition back to axis-0 order.
    # Chain-word step per axis: +1 along axes j < d, -d along axis d; the
    # ascending-s sort makes the sorted-neighbor coordinate-sum difference
    # +1 resp. +d (matching build_plan_chain's _axis_tap_weights steps).
    # mult[j] == 1 for j < d, so the point hashes are recovered exactly from
    # the keys (h = c + s*oh).  Axes 0..d-2 are alike and run under one
    # lax.scan (one compiled sort; see _blur_axes).
    def axis(c1, c2, s_, cols, step, h1, h2, oh1n, oh2n, mult_n, carry_h):
        tapw_j = _tapw_full(c1, c2, s_, step, order, cs)
        cols = tuple(_chain_stencil_1d(t, tapw_j, center, order) for t in cols)
        dead = s_ == _INT32_MAX
        n_c1 = jnp.where(dead, _INT32_MAX, mult_n * h1 - s_ * oh1n)
        n_c2 = jnp.where(dead, _INT32_MAX, mult_n * h2 - s_ * oh2n)
        out = jax.lax.sort((n_c1, n_c2, s_) + cols + ((h1, h2) if carry_h else ()), num_keys=3)
        return out[0], out[1], out[2], tuple(out[3 : 3 + c_in]), out[3 + c_in :]

    def uniform_axis(state, xs):
        c1, c2, s_, cols = state
        o1, o2, o1n, o2n = xs
        h1, h2 = c1 + s_ * o1, c2 + s_ * o2
        c1, c2, s_, cols, _ = axis(c1, c2, s_, cols, 1, h1, h2, o1n, o2n, 1, False)
        return (c1, c2, s_, cols), None

    oh1a, oh2a = jnp.asarray(oh1, jnp.int32), jnp.asarray(oh2, jnp.int32)
    (c1, c2, s_, tcols), _ = jax.lax.scan(
        uniform_axis, (u_c1, u_c2, u_s, tcols), (oh1a[: d - 1], oh2a[: d - 1], oh1a[1:d], oh2a[1:d])
    )
    # Axis d-1, into axis-d order: axis d's multiplier (-d) is not
    # invertible, so the point hashes ride along as sort payloads.
    h1, h2 = c1 + s_ * oh1[d - 1], c2 + s_ * oh2[d - 1]
    c1, c2, s_, tcols, (h1, h2) = axis(c1, c2, s_, tcols, 1, h1, h2, oh1[d], oh2[d], mult[d], True)
    # Axis d, back into axis-0 (dedup) order.
    _, _, _, tcols, _ = axis(c1, c2, s_, tcols, d, h1, h2, oh1[0], oh2[0], mult[0], False)

    # The table is back in dedup (axis-0 chain) order: padding rows pin all
    # three sort keys to INT32_MAX, so live rows occupy positions
    # 0..n_lattice-1 in their original relative order (a live row could only
    # sort among padding under a full 96-bit key tie, ~2^-64).  Slice indexes
    # it directly with the contribution segment ids, un-sorted to input order.
    _, seg_orig = jax.lax.sort((I, seg_sorted), num_keys=1)
    # ONE (c, M) slice gather + contiguous vertex-sum (layout discipline
    # and per-row gather economics: see apply_plan_chain's slice).
    tableT = jnp.stack(tcols, axis=0)  # (c, Mc)
    gathered = tableT[:, seg_orig]  # (c, M)
    out_cols = []
    for k in range(c_in):
        gw = gathered[k] * weights
        acc = gw[0:n]
        for jj in range(1, dp1):
            acc = acc + gw[jj * n : (jj + 1) * n]
        out_cols.append(acc)
    out = jnp.stack(out_cols, axis=-1) * SLICE_NORM(d)
    # Capacity guard, as in apply_plan_chain.
    return jnp.where(n_lattice <= Mc, out, jnp.float32(jnp.nan))


def build_plan(
    x: jax.Array, coeffs: tuple, blur_variance: float, capacity: Optional[int] = None
) -> ChainPlan:
    """Default plan builder: the sort-chain plan (see build_plan_chain)."""
    return build_plan_chain(x, coeffs, blur_variance, capacity=capacity)


def apply_plan(plan, v: jax.Array, coeffs: tuple, axis_name: Optional[str] = None):
    """Apply a lattice plan (dispatches on plan type).

    ChainPlan: single-device sort-chain engine (the default / fastest).
    LatticePlan: gather-based join engine; also the data-sharded path
    (``axis_name`` inside shard_map; see parallel/shard_filter.py).
    """
    if isinstance(plan, ChainPlan):
        return apply_plan_chain(plan, v, coeffs, axis_name=axis_name)
    return apply_plan_join(plan, v, coeffs, axis_name=axis_name)
