"""Fast algebra on the recursively off-diagonal low-rank matrix
(counterpart of ``repro.core.hmatrix``, paper section 3).

  * :func:`matvec`  -- Algorithm 1, y = A b in O(n r);
  * :func:`invert`  -- Algorithm 2, the structured (A + ridge I)^-1 in
                       O(n r^2), returned as another factor set;
                       :func:`invert_multi` over a grid of ridges, with
                       one leaf factorization launch for the whole grid;
  * :func:`apply_inverse`, :func:`solve_with_inverse`, :func:`solve` --
                       the inverse applied, polished by iterative
                       refinement;
  * :func:`logdet`  -- log det (A + ridge I) from the Algorithm-2
                       byproducts;
  * :func:`invert_extend` -- the inverse of leaves grown by an online
                       insert, bordering the old leaf factors.

The leaf stages go through the backend registry: ``leaf_matvec`` (matvec,
and the explicit-inverse apply), ``leaf_solve`` (the fused block-Cholesky
apply), ``leaf_factor`` (the leaf Schur Cholesky and its inverse) and
``leaf_update`` (its bordered extension after an online insert); on
the card each is a CUDA kernel.  The level recursions between them are
plain torch on (2**l, r, r) stacks, as they are plain jnp in the
reference.  Every right-hand side may be (n,) or (n, k).

``c_i`` and ``d_i`` of a node live in the landmark space of its parent;
``W_i`` (r x r) maps parent basis -> node basis; the sibling exchange
applies the parent's Sigma.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hck import HCKFactors
from repro_torch.kernels.registry import (DEFAULT_CONFIG, SolveConfig,
                                          get_impl, resolve_backend)

Tensor = torch.Tensor


def _pair_sum(x: Tensor) -> Tensor:
    """(2B, ...) -> (B, ...): sum over sibling pairs."""
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).sum(dim=1)


def _pair_swap(x: Tensor) -> Tensor:
    """(2B, ...) -> (2B, ...): exchange each sibling pair."""
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).flip(1).reshape(x.shape)


def _rep2(x: Tensor) -> Tensor:
    """(B, ...) -> (2B, ...): broadcast parents to their two children."""
    return torch.repeat_interleave(x, 2, dim=0)


def _as_batch(b: Tensor) -> tuple[Tensor, bool]:
    """(n,) or (n, k) -> ((n, k), squeeze_flag)."""
    if b.ndim == 1:
        return b[:, None], True
    return b, False


def _offdiag_apply(sigma: tuple, w: tuple, u: Tensor, c_leaf: Tensor,
                   levels: int) -> Tensor:
    """Upward, sibling-exchange and downward sweeps of Algorithm 1.

    Given the leaf coefficients ``c_leaf = U^T b`` returns the per-leaf
    off-diagonal contribution ``U d_leaf`` (the same traversal serves A and
    its inverse; only the factor values differ).
    """
    c = {levels: c_leaf}
    for lvl in range(levels - 1, 0, -1):
        c[lvl] = torch.einsum("pab,pak->pbk", w[lvl - 1],
                              _pair_sum(c[lvl + 1]))
    d = {lvl: torch.einsum("qab,qbk->qak", _rep2(sigma[lvl - 1]),
                           _pair_swap(c[lvl]))
         for lvl in range(1, levels + 1)}
    for lvl in range(1, levels):
        push = torch.einsum("pab,pbk->pak", w[lvl - 1], d[lvl])
        d[lvl + 1] = d[lvl + 1] + _rep2(push)
    return torch.einsum("pnr,prk->pnk", u, d[levels])


def _leaf_stage(stage: str, config: SolveConfig, *tensors: Tensor):
    """Run a leaf stage on contiguous operands through the registry."""
    tensors = tuple(t.contiguous() for t in tensors)
    backend = resolve_backend(config, stage, *tensors)
    return get_impl(stage, backend)(*tensors)


# ---------------------------------------------------------------------------
# Algorithm 1 -- matvec
# ---------------------------------------------------------------------------

def matvec(f: HCKFactors, b: Tensor, config: SolveConfig | None = None
           ) -> Tensor:
    """y = K_hck(X, X) b for b of shape (n,) or (n, k).

    The fused leaf stage (y_i = A_ii b_i, c_i = U_i^T b_i) is the
    ``leaf_matvec`` stage, a CUDA kernel on the card.
    """
    config = config if config is not None else DEFAULT_CONFIG
    b, squeeze = _as_batch(b)
    n, k = b.shape
    bb = b.reshape(f.num_leaves, f.leaf_size, k)
    y, c_leaf = _leaf_stage("leaf_matvec", config, f.adiag, f.u, bb)
    if f.levels > 0:
        y = y + _offdiag_apply(f.sigma, f.w, f.u, c_leaf, f.levels)
    out = y.reshape(n, k)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Algorithm 2 -- structured inversion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InverseFactors:
    """Hierarchical factors of (A + ridge I)^-1; same layout as HCKFactors.

    ``linv`` carries the inverse Cholesky factors of the leaf Schur
    complements (``adiag = linv^T linv + u sigma_self u^T``), which the
    fused ``leaf_solve`` stage applies instead of the explicit blocks.
    """

    adiag: Tensor          # (2**L, n0, n0) diagonal blocks of the inverse
    u: Tensor              # (2**L, n0, r)
    sigma: tuple           # levels 0..L-1: (2**l, r, r) corrected middle factors
    w: tuple               # levels 1..L-1: (2**l, r, r)
    logabsdet: Tensor      # scalar: log |det(A + ridge I)|
    linv: Tensor | None = None   # (2**L, n0, n0) inv Cholesky of leaf Schur

    @property
    def levels(self) -> int:
        """Tree depth L."""
        return len(self.sigma)

    @property
    def num_leaves(self) -> int:
        """Leaf count 2**L."""
        return self.adiag.shape[0]

    @property
    def leaf_size(self) -> int:
        """Points per leaf n0."""
        return self.adiag.shape[1]

    @property
    def rank(self) -> int:
        """Landmarks per node r."""
        return self.u.shape[-1]

    def at(self, g: int) -> "InverseFactors":
        """Grid point ``g`` of a stacked :func:`invert_multi` result (every
        tensor carries a leading grid axis).  The slices of contiguous
        stacks stay contiguous, so the leaf kernels take them in place."""
        return InverseFactors(
            self.adiag[g], self.u[g], tuple(s[g] for s in self.sigma),
            tuple(w[g] for w in self.w), self.logabsdet[g],
            None if self.linv is None else self.linv[g])


def _stage_leaf_factor(dleaf: Tensor, config: SolveConfig
                       ) -> tuple[Tensor, Tensor]:
    """The ``leaf_factor`` stage: (P, n0, n0) SPD -> (L, L^-1), both lower."""
    return _leaf_stage("leaf_factor", config, dleaf)


def _invert_level0(f: HCKFactors, ridge: float) -> InverseFactors:
    """Degenerate 0-level hierarchy: one dense block, inverted directly."""
    eye = torch.eye(f.leaf_size, dtype=f.adiag.dtype, device=f.adiag.device)
    adiag = f.adiag + ridge * eye
    _, ld = torch.linalg.slogdet(adiag[0])
    return InverseFactors(torch.linalg.inv_ex(adiag)[0], f.u, (), (), ld)


def _leaf_schur(f: HCKFactors) -> Tensor:
    """Ridge-independent part of the leaf Schur complements,
    ``adiag - U Sigma_parent U^T``; the sibling leaves of a parent read its
    Sigma in place (no per-leaf copy)."""
    p, n0, r = f.u.shape
    u2 = f.u.reshape(p // 2, 2, n0, r)
    low = torch.einsum("pcnr,prs,pcms->pcnm", u2, f.sigma[f.levels - 1], u2)
    return f.adiag - low.reshape(p, n0, n0)


def _invert_tail(f: HCKFactors, lo: Tensor, linv: Tensor) -> InverseFactors:
    """Everything after the leaf factorization of Algorithm 2: batched
    products, ``slogdet`` and ``solve`` on the (2**l, r, r) middle
    factors."""
    levels, r = f.levels, f.rank
    eye_r = torch.eye(r, dtype=f.adiag.dtype, device=f.adiag.device)

    adiag_t = torch.einsum("pmn,pmk->pnk", linv, linv)
    logdet_acc = 2.0 * torch.sum(torch.log(torch.abs(
        torch.diagonal(lo, dim1=-2, dim2=-1))))
    u_t = torch.einsum("pnm,pmr->pnr", adiag_t, f.u)
    theta = {levels: torch.einsum("pnr,pns->prs", f.u, u_t)}
    xi, sigma_t, w_t, e_t = {}, {}, {}, {}

    # upward, internal levels L-1 .. 0
    for lvl in range(levels - 1, -1, -1):
        child = lvl + 1
        if child < levels:
            w_t[child] = torch.einsum(
                "pab,pbc->pac", eye_r + torch.einsum(
                    "pab,pbc->pac", sigma_t[child], xi[child]),
                f.w[child - 1])
            theta[child] = torch.einsum(
                "pba,pbc,pcd->pad", f.w[child - 1], xi[child], w_t[child])
        xi[lvl] = _pair_sum(theta[child])
        if lvl > 0:
            lam = f.sigma[lvl] - torch.einsum(
                "pab,pbc,pdc->pad", f.w[lvl - 1], _rep2(f.sigma[lvl - 1]),
                f.w[lvl - 1])
        else:
            lam = f.sigma[0]
        m = eye_r + torch.einsum("pab,pbc->pac", lam, xi[lvl])
        _, ld = torch.linalg.slogdet(m)
        logdet_acc = logdet_acc + torch.sum(ld)
        # solve_ex, like jnp.linalg.solve, does not raise on a singular
        # or NaN m (cuSOLVER reports a NaN factor singular): the failure
        # reaches the health probes as NaN, as in the reference
        sigma_t[lvl] = -torch.linalg.solve_ex(m, lam)[0]
        if child < levels:
            e_t[child] = torch.einsum(
                "pab,pbc,pdc->pad", w_t[child], _rep2(sigma_t[lvl]),
                w_t[child])

    # downward: cascade the E~ corrections, then fix the leaf diagonals
    for lvl in range(1, levels):
        if lvl >= 2:
            e_t[lvl] = e_t[lvl] + torch.einsum(
                "pab,pbc,pdc->pad", w_t[lvl], _rep2(e_t[lvl - 1]), w_t[lvl])
        sigma_t[lvl] = sigma_t[lvl] + e_t[lvl]
    adiag_t = adiag_t + torch.einsum(
        "pnr,prs,pms->pnm", u_t, _rep2(sigma_t[levels - 1]), u_t)

    # contiguous once here, so the leaf stages never copy them per apply
    # (torch.linalg.solve_ex returns column-major batches)
    return InverseFactors(
        adiag=adiag_t.contiguous(), u=u_t.contiguous(),
        sigma=tuple(sigma_t[lvl].contiguous() for lvl in range(levels)),
        w=tuple(w_t[lvl].contiguous() for lvl in range(1, levels)),
        logabsdet=logdet_acc, linv=linv)


def _leaf_factors(f: HCKFactors, ridge: float, config: SolveConfig):
    """(lo, linv) of the ridged leaf Schur complements."""
    eye = torch.eye(f.leaf_size, dtype=f.adiag.dtype, device=f.adiag.device)
    return _stage_leaf_factor(_leaf_schur(f) + ridge * eye, config)


def invert(f: HCKFactors, ridge: float = 0.0,
           config: SolveConfig | None = None) -> InverseFactors:
    """Algorithm 2: factors of (K_hck + ridge I)^-1, O(n r^2).

    ``ridge`` is added to the leaf diagonal blocks before inversion.  The
    leaf Schur Cholesky and its inverse are the ``leaf_factor`` stage.
    """
    config = config if config is not None else DEFAULT_CONFIG
    if f.levels == 0:
        return _invert_level0(f, ridge)
    return _invert_tail(f, *_leaf_factors(f, ridge, config))


def invert_with_leaf(f: HCKFactors, ridge: float = 0.0,
                     config: SolveConfig | None = None
                     ) -> tuple[InverseFactors, Tensor]:
    """:func:`invert` that also returns the leaf Schur Cholesky ``lo``
    (2**L, n0, n0), whose inverse is ``inv.linv``.  Needs levels >= 1."""
    config = config if config is not None else DEFAULT_CONFIG
    if f.levels == 0:
        raise ValueError("invert_with_leaf needs levels >= 1; use invert "
                         "for the dense 0-level hierarchy")
    lo, linv = _leaf_factors(f, ridge, config)
    return _invert_tail(f, lo, linv), lo


def _stage_leaf_update(lo: Tensor, linv: Tensor, b: Tensor, c: Tensor,
                       config: SolveConfig) -> tuple[Tensor, Tensor]:
    """The ``leaf_update`` stage: the (P, n0, n0) pair bordered by the
    (P, k, n0) cross and (P, k, k) appended blocks -> the (P, n0 + k,
    n0 + k) pair, leading quadrants untouched."""
    return _leaf_stage("leaf_update", config, lo, linv, b, c)


def extension_blocks(f: HCKFactors, *, n0_base: int, ridge: float = 0.0
                     ) -> tuple[Tensor, Tensor]:
    """Appended blocks of the ridged leaf Schur complements of leaves that
    grew from ``n0_base`` to ``n0_base + k`` rows (an online insert,
    :mod:`repro_torch.core.update`): the (P, k, n0_base) cross block and
    the (P, k, k) appended diagonal block of ``adiag - U Sigma_parent U^T
    + ridge I``, the inputs of the ``leaf_update`` stage.  The ridge lands
    on the appended diagonal only (the old block already carries it)."""
    sig_p = _rep2(f.sigma[f.levels - 1])
    u_old, u_app = f.u[:, :n0_base], f.u[:, n0_base:]
    k = f.leaf_size - n0_base
    b = f.adiag[:, n0_base:, :n0_base] - torch.einsum(
        "pkr,prs,pns->pkn", u_app, sig_p, u_old)
    c = (f.adiag[:, n0_base:, n0_base:]
         - torch.einsum("pkr,prs,pls->pkl", u_app, sig_p, u_app)
         + ridge * torch.eye(k, dtype=f.adiag.dtype, device=f.adiag.device))
    return b, c


def invert_extend(f: HCKFactors, lo: Tensor, linv: Tensor, *, n0_base: int,
                  ridge: float = 0.0, config: SolveConfig | None = None
                  ) -> tuple[InverseFactors, Tensor]:
    """Algorithm 2 on row-extended factors, reusing the old leaf Cholesky.

    ``f``'s leaves grew from ``n0_base`` rows by an online insert; its
    leading leaf blocks, landmarks, Sigma and W are unchanged, so each
    leaf's ridged Schur complement is a bordered extension of the one
    ``(lo, linv)`` factor: the appended blocks (:func:`extension_blocks`)
    go through the ``leaf_update`` stage (B13 on the card, O(k n0^2) per
    leaf) and only the middle-factor tail of Algorithm 2 runs again.
    ``ridge`` must be the one ``(lo, linv)`` were factored with.  Returns
    ``(inv, lo_ext)``, matching ``invert_with_leaf(f, ridge)`` to
    round-off.
    """
    config = config if config is not None else DEFAULT_CONFIG
    k = f.leaf_size - n0_base
    if k < 0:
        raise ValueError(f"extended leaf size {f.leaf_size} smaller than "
                         f"base {n0_base}")
    if k == 0:
        return _invert_tail(f, lo, linv), lo
    b, c = extension_blocks(f, n0_base=n0_base, ridge=ridge)
    lo_ext, linv_ext = _stage_leaf_update(lo, linv, b, c, config)
    return _invert_tail(f, lo_ext, linv_ext), lo_ext


def invert_multi(f: HCKFactors, ridges,
                 config: SolveConfig | None = None) -> InverseFactors:
    """Algorithm 2 over a grid of ridges: one build, G inversions.

    Returns an :class:`InverseFactors` whose every tensor carries a leading
    grid axis G = len(ridges) (``logabsdet`` is (G,)); ``.at(g)`` equals
    ``invert(f, ridges[g], config)``.  The factors do not depend on the
    ridge, so the ridge-free part of the leaf Schur complements is formed
    once and all G * 2**L ridged leaves go through ONE ``leaf_factor``
    launch; the middle-factor tail then runs once per ridge.
    """
    return invert_multi_with_leaf(f, ridges, config)[0]


def invert_multi_with_leaf(f: HCKFactors, ridges,
                           config: SolveConfig | None = None
                           ) -> tuple[InverseFactors, Tensor | None]:
    """:func:`invert_multi` that also returns the stacked leaf Schur
    Cholesky factors ``lo`` (G, 2**L, n0, n0) (None for a 0-level
    hierarchy).  ``lo[g]`` and ``.at(g).linv`` are bit for bit those of
    ``invert_with_leaf(f, ridges[g])``: the kernel factors each block on
    its own, whatever the batch."""
    config = config if config is not None else DEFAULT_CONFIG
    ridges = torch.as_tensor(ridges, dtype=f.adiag.dtype,
                             device=f.adiag.device)
    if ridges.ndim != 1:
        raise ValueError(f"ridges must be 1-D, got shape "
                         f"{tuple(ridges.shape)}")
    g = ridges.shape[0]
    if f.levels == 0:
        invs = [_invert_level0(f, ridge) for ridge in ridges]
        lo = linv = None
    else:
        p, n0 = f.num_leaves, f.leaf_size
        eye = torch.eye(n0, dtype=f.adiag.dtype, device=f.adiag.device)
        dleaf = _leaf_schur(f)[None] + ridges[:, None, None, None] * eye
        lo, linv = _stage_leaf_factor(dleaf.reshape(g * p, n0, n0), config)
        # contiguous stacks (the plain version's are column-major), so that
        # every grid point's slice goes to the leaf kernels in place
        lo = lo.contiguous().reshape(g, p, n0, n0)
        linv = linv.contiguous().reshape(g, p, n0, n0)
        invs = [_invert_tail(f, lo[i], linv[i]) for i in range(g)]
    inv = InverseFactors(
        adiag=torch.stack([inv.adiag for inv in invs]),
        u=torch.stack([inv.u for inv in invs]),
        sigma=tuple(torch.stack(s) for s in zip(*(i.sigma for i in invs))),
        w=tuple(torch.stack(w) for w in zip(*(i.w for i in invs))),
        logabsdet=torch.stack([inv.logabsdet for inv in invs]), linv=linv)
    return inv, lo


def apply_inverse(inv: InverseFactors, b: Tensor,
                  config: SolveConfig | None = None) -> Tensor:
    """x = (A + ridge I)^-1 b through the hierarchical structure, O(n r).

    Whenever the inverse carries its leaf factors ``linv``, the leaf stage
    is the fused ``leaf_solve`` -- ``Linv^T Linv b`` plus the self low-rank
    correction, the reference's pallas path -- on both backends: the CUDA
    kernel on the card, its plain version on the CPU.  The explicit
    inverse blocks (``leaf_matvec`` on ``adiag``, the reference's xla
    path) serve only an inverse without ``linv``: in float32 they lose the
    solve at covtype width (residual 4.4e-1 against the f32 floor 5.5e-3,
    ROADMAP item C4), where the factored form holds.  The off-diagonal
    sweeps are shared with :func:`matvec`.
    """
    config = config if config is not None else DEFAULT_CONFIG
    b, squeeze = _as_batch(b)
    n, k = b.shape
    levels = inv.levels
    bb = b.reshape(inv.num_leaves, inv.leaf_size, k).contiguous()
    if levels > 0 and inv.linv is not None:
        x, c_leaf = _leaf_stage("leaf_solve", config, inv.linv, inv.u,
                                inv.sigma[levels - 1], bb)
    else:
        x, c_leaf = _leaf_stage("leaf_matvec", config, inv.adiag, inv.u, bb)
    if levels > 0:
        x = x + _offdiag_apply(inv.sigma, inv.w, inv.u, c_leaf, levels)
    out = x.reshape(n, k)
    return out[:, 0] if squeeze else out


def solve_with_inverse(f: HCKFactors, inv: InverseFactors, b: Tensor,
                       ridge: float = 0.0,
                       config: SolveConfig | None = None) -> Tensor:
    """Apply a prebuilt structured inverse, then ``config.refine_steps``
    rounds of iterative refinement x += A~^-1 (b - (A + ridge I) x).

    Monotone safeguard: a round whose residual norm does not shrink is
    not accepted (a badly conditioned structured inverse would otherwise
    diverge).  The choice is made on the device, without a host sync.
    """
    config = config if config is not None else DEFAULT_CONFIG
    x = apply_inverse(inv, b, config)
    resid = b - (matvec(f, x, config) + ridge * x)
    for _ in range(config.refine_steps):
        x_new = x + apply_inverse(inv, resid, config)
        resid_new = b - (matvec(f, x_new, config) + ridge * x_new)
        better = (torch.linalg.vector_norm(resid_new)
                  < torch.linalg.vector_norm(resid))
        x = torch.where(better, x_new, x)
        resid = torch.where(better, resid_new, resid)
    return x


def solve(f: HCKFactors, b: Tensor, ridge: float = 0.0,
          config: SolveConfig | None = None) -> Tensor:
    """x = (K_hck + ridge I)^-1 b: :func:`invert`, then
    :func:`solve_with_inverse`."""
    return solve_with_inverse(f, invert(f, ridge, config), b, ridge, config)


def logdet(f: HCKFactors, ridge: float = 0.0,
           config: SolveConfig | None = None) -> Tensor:
    """log det (K_hck + ridge I), the GP-MLE term (paper section 6)."""
    return invert(f, ridge, config).logabsdet


def matvec_dense_reference(f: HCKFactors, b: Tensor) -> Tensor:
    """Oracle: materialize K_hck densely and multiply (tests only)."""
    from repro_torch.core.hck import to_dense

    return to_dense(f) @ b
