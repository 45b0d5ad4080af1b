"""Schedule verification as the planner uses it: the SGPV table checks,
the rotation-cycle spectral gap and its bounded memo.

A copy of the numpy part of ``stochastic_gradient_push_tpu/analysis/
verifier.py``:

* **SGPV101** every phase sub-round is a bijection of the ranks (a round
  can move it as one permutation);
* **SGPV102** every mixing matrix is column-stochastic (push-sum mass
  conservation);
* **SGPV103** the product of one full rotation cycle is an ergodic
  contraction, second-largest eigenvalue modulus below 1; its gap
  ``1 - |λ₂|`` is what the planner ranks by;
* **SGPV104** every bilateral pairing row is a fixed-point-free
  involution.

The gap is memoized by :func:`schedule_fingerprint` in an LRU bounded by
:func:`spectral_gap_cache_limit` (a synthesis search evaluates thousands
of one-off tables).  At :data:`SPARSE_GAP_WORLD_MIN` ranks and above the
gap comes from scipy's ARPACK on the table-scatter operator, with a
deterministic subspace iteration for clustered spectra and the dense
eigensolve as the fallback.  The reference's registry sweep
(``verify_topology``/``verify_package``, rule SGPV105/106) and its AST
engines are not ported.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np

from .findings import Finding

__all__ = ["verify_schedule", "verify_pairing", "is_unsupported_config",
           "schedule_fingerprint", "spectral_gap",
           "spectral_gap_cache_clear", "spectral_gap_cache_info",
           "spectral_gap_cache_limit", "SPARSE_GAP_WORLD_MIN"]

# ergodicity tolerance: a gap at/below this means the cycle product does
# not contract and push-sum cannot converge
GAP_HARD_MIN = 1e-9

_COLUMN_TOL = 1e-9


def _mixing_matrix(schedule, phase: int) -> np.ndarray:
    """Dense W for one phase, built from the raw tables (does not trust a
    fixture object's own ``mixing_matrix`` method)."""
    n = schedule.world_size
    w = np.zeros((n, n), dtype=np.float64)
    for src in range(n):
        w[src, src] += schedule.self_weight[phase, src]
        for i in range(schedule.peers_per_itr):
            w[schedule.perms[phase, i, src], src] += \
                schedule.edge_weights[phase, i, src]
    return w


def schedule_fingerprint(schedule) -> bytes:
    """Content hash of a schedule's mixing tables.

    Two schedules with identical ``perms``/``self_weight``/
    ``edge_weights`` (shapes included) have identical rotation-cycle
    products, so the fingerprint is a sound memoization key for every
    quantity derived from the cycle — in particular the spectral gap.
    """
    perms = np.ascontiguousarray(np.asarray(schedule.perms,
                                            dtype=np.int64))
    self_w = np.ascontiguousarray(np.asarray(schedule.self_weight,
                                             dtype=np.float64))
    edge_w = np.ascontiguousarray(np.asarray(schedule.edge_weights,
                                             dtype=np.float64))
    h = hashlib.sha1()
    h.update(repr((perms.shape, self_w.shape, edge_w.shape)).encode())
    h.update(perms.tobytes())
    h.update(self_w.tobytes())
    h.update(edge_w.tobytes())
    return h.digest()


# spectral-gap memo: the planner's candidate scoring rebuilds identical
# schedules many times per process (every plan_for call rescans the
# candidate grid).  The eigenvalue solve dominates, so cache the gap by
# table fingerprint.  The cache is an LRU bounded by
# spectral_gap_cache_limit(): a schedule-synthesis search
# (planner/synthesize.py) evaluates thousands of one-off candidate
# tables per run, so an unbounded dict would grow with every search a
# long-lived process performs while the hits that matter (the registry
# grid, the current search's frontier) all fit comfortably in the
# default bound.
_GAP_CACHE: "collections.OrderedDict[bytes, float]" = \
    collections.OrderedDict()
_GAP_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_GAP_CACHE_MAX = 4096


def spectral_gap_cache_info() -> dict:
    """{'hits', 'misses', 'evictions', 'size', 'max'} of the
    spectral-gap memo (testing / diagnostics)."""
    return {"hits": _GAP_STATS["hits"], "misses": _GAP_STATS["misses"],
            "evictions": _GAP_STATS["evictions"],
            "size": len(_GAP_CACHE), "max": _GAP_CACHE_MAX}


def spectral_gap_cache_limit(max_entries: int | None = None) -> int:
    """Get (and with an argument, set) the LRU bound.  Shrinking evicts
    oldest entries immediately; the bound must stay >= 1."""
    global _GAP_CACHE_MAX
    if max_entries is not None:
        if max_entries < 1:
            raise ValueError("spectral-gap cache limit must be >= 1")
        _GAP_CACHE_MAX = int(max_entries)
        while len(_GAP_CACHE) > _GAP_CACHE_MAX:
            _GAP_CACHE.popitem(last=False)
            _GAP_STATS["evictions"] += 1
    return _GAP_CACHE_MAX


def spectral_gap_cache_clear() -> None:
    _GAP_CACHE.clear()
    _GAP_STATS["hits"] = _GAP_STATS["misses"] = 0
    _GAP_STATS["evictions"] = 0


# world size at/above which the sparse Arnoldi lane computes the gap.
# The dense path densifies every phase matrix and eigensolves the n×n
# cycle product — O(num_phases·n³) — which is minutes at world 4096.
# Schedules are permutation+diagonal tables, so one cycle matvec is
# O(num_phases·ppi·n); ARPACK on that operator prices a large candidate
# in milliseconds.  The sparse lane falls back to dense on any solver
# failure, so this threshold changes the solve route, not a verdict.
SPARSE_GAP_WORLD_MIN = 128


def _cycle_apply(perms, self_w, edge_w, x):
    """Apply one full rotation-cycle product to ``x`` — a vector
    ``(world,)`` or a column block ``(world, b)`` — via the permutation
    +diagonal table scatters, never densifying a phase matrix.  Each
    perm row is a permutation (SGPV101), so the fancy-index scatter
    never collides and ``+=`` is exact without ``np.add.at``."""
    num_phases, ppi = perms.shape[0], perms.shape[1]
    cols = (slice(None), None) if x.ndim == 2 else slice(None)
    for p in range(num_phases):
        out = self_w[p][cols] * x
        for i in range(ppi):
            out[perms[p, i]] += edge_w[p, i][cols] * x
        x = out
    return x


def _subspace_gap(perms, self_w, edge_w, n: int, block: int = 16,
                  check_every: int = 64, rtol: float = 1e-9) -> float:
    """Deterministic block subspace iteration on the zero-sum-restricted
    cycle product: the always-terminating magnitude estimator behind the
    ARPACK lane.

    Restarted Arnoldi fails to converge when the top of the zero-sum
    spectrum clusters (a ring of thousands of ranks: hundreds of eigenvalues within
    O(gap) of |λ₂|).  Subspace iteration with Ritz extraction converges
    to the dominant invariant subspace instead, and in the clustered
    regime ANY cluster member approximates ``|λ₂|`` to within the
    cluster width — so the estimate's absolute error is O(gap) exactly
    when exact separation is unaffordable, and machine-tight when the
    spectrum separates.  The sweep budget scales with the world so a
    4096-rank ring resolves in seconds, not ARPACK's unbounded stall."""
    b = max(2, min(block, n - 1))
    rng = np.random.default_rng(0x5617)
    q_mat = rng.standard_normal((n, b))
    q_mat -= q_mat.mean(axis=0)          # zero-sum: P-invariant subspace
    q_mat = np.linalg.qr(q_mat)[0]
    sweeps = min(100_000, max(3_000, 20 * n))
    theta, stable = 0.0, 0
    for s in range(sweeps):
        z = _cycle_apply(perms, self_w, edge_w, q_mat)
        z -= z.mean(axis=0)              # pin numeric drift to zero-sum
        if (s + 1) % check_every == 0 or s == sweeps - 1:
            new = float(np.abs(np.linalg.eigvals(q_mat.T @ z)).max())
            if abs(new - theta) <= 1e-13 + rtol * abs(new):
                stable += 1
                if stable >= 2:          # two quiet checks = converged
                    return float(1.0 - new)
            else:
                stable = 0
            theta = new
        q_mat = np.linalg.qr(z)[0]
    return float(1.0 - theta)


def _sparse_gap(schedule) -> float:
    """``1 - |λ₂|`` from the cycle product restricted to the zero-sum
    subspace, never densifying a phase matrix.

    Every phase matrix is column-stochastic (``1ᵀW = 1ᵀ``), so the
    zero-sum subspace ``{x : Σx = 0}`` is invariant under the cycle
    product P and carries exactly the spectrum ``{λ₂, …, λ_n}``.  The
    operator ``x → P·(x − mean(x))`` therefore has spectral radius
    ``|λ₂|`` on its nonzero spectrum: for ``λ ≠ 0``, ``Mv = λv`` forces
    ``v`` into the (invariant) zero-sum range, where M acts as P.

    Two stages: a budgeted ARPACK solve (machine precision whenever the
    top of the spectrum separates — every exponential/hierarchical/
    synthesized schedule in practice), then the deterministic subspace
    iteration of :func:`_subspace_gap` when ARPACK's restarts stall on
    a clustered spectrum (rings of thousands of ranks)."""
    from scipy.sparse.linalg import ArpackError, LinearOperator, eigs

    perms = np.asarray(schedule.perms)
    self_w = np.asarray(schedule.self_weight, dtype=np.float64)
    edge_w = np.asarray(schedule.edge_weights, dtype=np.float64)
    n = schedule.world_size

    def matvec(v):
        x = np.asarray(v, dtype=np.float64).reshape(n)
        return _cycle_apply(perms, self_w, edge_w, x - x.mean())

    op = LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    # deterministic start vector: the gap must be a pure function of
    # the tables (the memo key) — ARPACK's default v0 is process-random
    v0 = np.random.default_rng(0x5617).standard_normal(n)
    try:
        lam = eigs(op, k=min(6, n - 2), ncv=min(64, n), which="LM",
                   v0=v0, tol=1e-10, maxiter=500,
                   return_eigenvectors=False)
        return float(1.0 - np.abs(lam).max())
    except ArpackError:
        # no convergence within the budget: clustered spectrum — the
        # subspace lane terminates deterministically on those
        return _subspace_gap(perms, self_w, edge_w, n)


def spectral_gap(schedule) -> float:
    """``1 - |λ₂|`` of the full rotation-cycle product (memoized by
    :func:`schedule_fingerprint` in a bounded LRU).

    Dense eigensolve below :data:`SPARSE_GAP_WORLD_MIN` ranks; the
    sparse table-scatter Arnoldi lane above it (dense fallback on any
    solver failure)."""
    fp = schedule_fingerprint(schedule)
    cached = _GAP_CACHE.get(fp)
    if cached is not None:
        _GAP_STATS["hits"] += 1
        _GAP_CACHE.move_to_end(fp)
        return cached
    _GAP_STATS["misses"] += 1
    n = schedule.world_size
    gap = None
    if n >= SPARSE_GAP_WORLD_MIN:
        try:
            gap = _sparse_gap(schedule)
        except ImportError:
            gap = None        # no scipy on this host: dense lane below
        except Exception:
            # ARPACK non-convergence or breakdown: the dense eigensolve
            # below is the always-correct fallback, just slower
            gap = None
    if gap is None:
        prod = np.eye(n)
        for p in range(schedule.num_phases):
            prod = _mixing_matrix(schedule, p) @ prod
        lam = np.sort(np.abs(np.linalg.eigvals(prod)))[::-1]
        gap = float(1.0 - (lam[1] if n > 1 else 0.0))
    _GAP_CACHE[fp] = gap
    while len(_GAP_CACHE) > _GAP_CACHE_MAX:
        _GAP_CACHE.popitem(last=False)
        _GAP_STATS["evictions"] += 1
    return gap


def verify_schedule(schedule, label: str, file: str, line: int
                    ) -> tuple[list[Finding], float]:
    """Check bijection + column-stochasticity + ergodicity of one
    schedule-like object (anything with perms/self_weight/edge_weights/
    num_phases/world_size/peers_per_itr).  Returns (findings, gap)."""
    findings: list[Finding] = []
    n = schedule.world_size
    ident = np.arange(n)

    for p in range(schedule.num_phases):
        for i in range(schedule.peers_per_itr):
            dests = np.asarray(schedule.perms[p, i])
            if not np.array_equal(np.sort(dests), ident):
                findings.append(Finding(
                    file, line, "SGPV101",
                    f"{label}: phase {p} sub-round {i} destination table "
                    f"is not a permutation of range({n})"))
        totals = (np.asarray(schedule.self_weight[p], dtype=np.float64)
                  + np.asarray(schedule.edge_weights[p],
                               dtype=np.float64).sum(axis=0))
        bad = np.abs(totals - 1.0) > _COLUMN_TOL
        if bad.any():
            ranks = np.flatnonzero(bad)[:4].tolist()
            findings.append(Finding(
                file, line, "SGPV102",
                f"{label}: phase {p} column sums deviate from 1 at ranks "
                f"{ranks} (push-sum mass not conserved)"))

    gap = float("nan")
    if not findings:  # gap is meaningless on malformed tables
        gap = spectral_gap(schedule)
        if n > 1 and gap <= GAP_HARD_MIN:
            findings.append(Finding(
                file, line, "SGPV103",
                f"{label}: rotation cycle has zero spectral gap "
                f"(|λ₂| ≈ 1); gossip cannot reach consensus"))
    return findings, gap


def verify_pairing(pairing: np.ndarray, label: str, file: str, line: int
                   ) -> list[Finding]:
    """Check each pairing row is a fixed-point-free involution."""
    findings: list[Finding] = []
    pairing = np.asarray(pairing)
    num_phases, n = pairing.shape
    ident = np.arange(n)
    for p in range(num_phases):
        row = pairing[p]
        ok = (np.array_equal(np.sort(row), ident)
              and np.array_equal(row[row], ident)
              and (n == 1 or not np.any(row == ident)))
        if not ok:
            findings.append(Finding(
                file, line, "SGPV104",
                f"{label}: pairing phase {p} is not a fixed-point-free "
                f"involution"))
    return findings


def is_unsupported_config(err: ValueError) -> bool:
    """Constructor refusals that mean 'configuration unsupported', not
    'generator broken'.  Public: the planner uses the same predicate so
    it skips exactly the cells the verifier skips."""
    msg = str(err)
    needles = ("unsupported", "even world size", "exceeds phone-book",
               "no hop distance", "requires an even", "must be >=")
    return any(s in msg for s in needles)
