"""Port parity: landmark policies and rank budgets (repro_torch.landmarks,
the policy and budget options of repro_torch.core.hck and krr.fit).

The same numpy inputs go through the JAX reference in float64 (its ``xla``
path) and through the port's plain PyTorch path on the CPU.  Random draws
do not cross frameworks, so the reference's draws are rebuilt from its key
chain and injected: the partition directions, the uniform landmark rows
(also k-means' start) and the leverage policy's pilot rows and Gumbel
noise.  Indices, ranks and masks must agree exactly; factors to 1e-10
relative, predictions to 1e-8.  The budget tests run at rank 32: at rank 8
every extra snaps to 0 and the masks are trivial.  The CUDA kernel B12
runs only on the card, where chip_smoke.py holds it against these plain
versions.

The points lie on a grid of 1/64: the k-means medoid of a two-point
cluster is a tie in exact arithmetic, and on the grid both frameworks
compute its two distances exactly, so both take the first of the two.  On
real-valued points round-off breaks such a tie, differently between the
reference's own jitted and eager runs (5 of the 128 medoids at level 2 of
this problem), let alone between frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_oos import flatten_model

from repro.core import hck as jhck
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.policy_stage.ref import policy_dist_ref as jpolicy_dist_ref
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.landmarks import budget as jbudget
from repro.landmarks import policy as jpolicy
from repro_torch import convert
from repro_torch.core import hck, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import registry
from repro_torch.kernels.policy_stage import ops as policy_ops
from repro_torch.kernels.policy_stage.ref import policy_dist_ref
from repro_torch.landmarks import budget, policy

N, D, LEVELS, RANK = 512, 5, 3, 32          # leaves of 64
NODES = (1 << LEVELS) - 1
BUDGET = NODES * RANK // 2                  # half of the 224 slots
SIGMA, JITTER, LAM = 1.5, 1e-8, 1e-2
XLA = JSolveConfig(backend="xla")
POLICIES = ["kmeans", "leverage"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def policy_draws(kbuild, n, levels, rank, name, pilot_mult=2):
    """The reference build's per-level policy draws from key ``kbuild``:
    ``kpart, key = split(kbuild)``, then ``key, sub = split(key)`` per
    level; k-means starts from the uniform draw of ``sub``, leverage splits
    ``sub`` into its pilot and Gumbel keys."""
    _, key = jax.random.split(kbuild)
    out = []
    for lvl in range(levels):
        key, sub = jax.random.split(key)
        bsz, m = 1 << lvl, n >> lvl
        if name == "leverage":
            p = min(pilot_mult * rank, m)
            kp, kg = jax.random.split(sub)
            out.append({
                "pilot_index": _t(jhck.landmark_indices(kp, bsz, m, p)),
                "gumbel": _t(jax.random.gumbel(kg, (bsz, m), jnp.float64))})
        else:
            out.append({"index": _t(jhck.landmark_indices(sub, bsz, m,
                                                          rank))})
    return out


def _factors_close(f, jf, rtol=1e-10):
    np.testing.assert_array_equal(f.tree.perm.numpy(), np.asarray(jf.tree.perm))
    for field in ("landmarks", "sigma", "sigma_cho", "w"):
        for got, want in zip(getattr(f, field), getattr(jf, field)):
            _close(got, want, rtol)
    _close(f.u, jf.u, rtol)
    _close(f.adiag, jf.adiag, rtol)
    if jf.rank_mask is None:
        assert f.rank_mask is None
    else:
        for got, want in zip(f.rank_mask, jf.rank_mask):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def problem(f64):
    rng = np.random.default_rng(21)
    x = np.round(64 * rng.standard_normal((N, D))) / 64    # a 1/64 grid
    y = np.sin(x).sum(axis=1)
    return x, y, rng.standard_normal((40, D)), jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def builds(problem):
    """Per policy: the reference's budgeted build and the port's on the
    reference's draws."""
    x, _, _, key = problem
    out = {}
    for name in POLICIES:
        jf = jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK,
                            key=key, config=XLA, policy=name,
                            kernel=JKernel("gaussian", SIGMA, JITTER),
                            rank_budget=BUDGET)
        f = hck.build_hck(
            _t(x), levels=LEVELS, rank=RANK, policy=name, rank_budget=BUDGET,
            kernel=BaseKernel("gaussian", SIGMA, JITTER),
            directions=[_t(v) for v in jf.tree.directions],
            policy_draws=policy_draws(key, N, LEVELS, RANK, name))
        out[name] = (jf, f)
    return out


# ---------------------------------------------------------------------------
# B12 policy_dist: plain version vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_policy_dist_matches_reference(f64, metric):
    rng = np.random.default_rng(3)
    blocks, centers = (rng.standard_normal(s) for s in ((4, 40, 5),
                                                         (4, 9, 5)))
    want = jpolicy_dist_ref(jnp.asarray(blocks), jnp.asarray(centers),
                            metric=metric)
    before = policy_ops.policy_dist.launches
    for got in (policy_dist_ref(_t(blocks), _t(centers), metric=metric),
                policy_ops.policy_dist(_t(blocks), _t(centers), metric=metric),
                registry.get_impl("policy_dist", "torch")(
                    _t(blocks), _t(centers), metric=metric)):
        _close(got, want)
    assert policy_ops.policy_dist.launches == before   # no kernel on the CPU


def test_policy_dist_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="metric"):
        policy_ops.policy_dist(torch.zeros(2, 4, 3), torch.zeros(2, 2, 3),
                               metric="l3")
    with pytest.raises(ValueError, match="policy_dist"):
        policy_ops.policy_dist(torch.zeros(2, 4, 3), torch.zeros(3, 2, 3))
    for backend in ("torch", "cuda"):
        assert registry.get_impl("policy_dist", backend) is not None


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def test_get_policy_resolution():
    assert isinstance(policy.get_policy(None), policy.UniformPolicy)
    for name, cls in (("uniform", policy.UniformPolicy),
                      ("kmeans", policy.KMeansPolicy),
                      ("leverage", policy.LeveragePolicy)):
        p = policy.get_policy(name)
        assert isinstance(p, cls) and p.name == name
        assert isinstance(p, policy.LandmarkPolicy)
    custom = policy.KMeansPolicy(iters=2)
    assert policy.get_policy(custom) is custom
    with pytest.raises(ValueError, match="unknown landmark policy"):
        policy.get_policy("farthest")


def test_uniform_policy_is_the_plain_build(problem):
    """policy="uniform" is the plain build bit for bit, in the port (the
    same generator) and in the reference (the same key)."""
    x, _, _, key = problem
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    fa, fb = (hck.build_hck(_t(x), levels=LEVELS, rank=RANK, kernel=ker,
                            policy=pol,
                            generator=torch.Generator().manual_seed(4))
              for pol in (None, "uniform"))
    for field in ("x_sorted", "u", "adiag"):
        assert torch.equal(getattr(fa, field), getattr(fb, field))
    for field in ("landmarks", "sigma", "sigma_cho", "w"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(fa, field),
                                                      getattr(fb, field)))
    jk = JKernel("gaussian", SIGMA, JITTER)
    ja, jb = (jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK,
                             key=key, kernel=jk, config=XLA, policy=pol)
              for pol in (None, "uniform"))
    np.testing.assert_array_equal(np.asarray(ja.u), np.asarray(jb.u))
    f = hck.build_hck(_t(x), levels=LEVELS, rank=RANK, kernel=ker,
                      policy="uniform",
                      directions=[_t(v) for v in ja.tree.directions],
                      policy_draws=policy_draws(key, N, LEVELS, RANK,
                                                "uniform"))
    _factors_close(f, ja)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_policy_indices_match_reference(problem, builds, name, metric):
    """Each level's indices on the reference's node blocks, with its draws
    injected, are the reference's, index for index."""
    _, _, _, key = problem
    jf = builds[name][0]
    draws = policy_draws(key, N, LEVELS, RANK, name)
    _, kl = jax.random.split(key)
    for lvl in range(LEVELS):
        kl, sub = jax.random.split(kl)
        blocks = jnp.reshape(jf.x_sorted, (1 << lvl, N >> lvl, D))
        want = jpolicy.get_policy(name).select(sub, blocks, RANK,
                                               metric=metric, config=XLA)
        got = policy.select_indices(name, _t(blocks), RANK, metric,
                                    draws=draws[lvl])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert all(torch.unique(row).numel() == RANK for row in got)


def test_own_draws_give_distinct_rows(problem):
    """The port's own draws (a generator, no injection): every node's
    landmarks are distinct rows of its own block, for every policy."""
    x = _t(problem[0])
    for name in ("uniform",) + tuple(POLICIES):
        f = hck.build_hck(x, levels=LEVELS, rank=RANK, kernel=BaseKernel(),
                          policy=name, generator=torch.Generator().manual_seed(9))
        for lvl, lm in enumerate(f.landmarks):
            blocks = f.x_sorted.reshape(1 << lvl, N >> lvl, D)
            for node in range(1 << lvl):
                match = (lm[node][:, None, :] == blocks[node][None]).all(-1)
                assert (match.sum(1) >= 1).all()
                assert torch.unique(lm[node], dim=0).shape[0] == RANK
    with pytest.raises(ValueError, match="policy_draws"):
        hck.build_hck(x, levels=LEVELS, rank=RANK, kernel=BaseKernel(),
                      policy="leverage", landmark_index=[
                          torch.zeros((1 << lvl, RANK), dtype=torch.int64)
                          for lvl in range(LEVELS)])


# ---------------------------------------------------------------------------
# Budgets
# ---------------------------------------------------------------------------

def test_allocate_ranks_and_masks_match_reference(f64):
    rng = np.random.default_rng(8)
    grams = []
    for lvl in range(LEVELS):
        a = rng.standard_normal((1 << lvl, RANK, RANK // (lvl + 2)))
        grams.append(a @ a.transpose(0, 2, 1) + 0.1 * np.eye(RANK))
    masses = np.concatenate([np.asarray(jbudget.node_mass(jnp.asarray(g)))
                             for g in grams])
    _close(torch.cat([budget.node_mass(_t(g)) for g in grams]), masses)
    for bud in (NODES, 3 * NODES, BUDGET, NODES * RANK, 10 * NODES * RANK):
        want = jbudget.allocate_ranks(jnp.asarray(masses), bud, RANK)
        got = budget.allocate_ranks(_t(masses), bud, RANK)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) <= bud and int(got.min()) >= 1
        assert int(got.max()) <= RANK
    assert len(set(np.asarray(budget.allocate_ranks(
        _t(masses), BUDGET, RANK)).tolist())) > 1    # the masks are ragged
    with pytest.raises(ValueError, match="below one landmark"):
        budget.allocate_ranks(_t(masses), NODES - 1, RANK)
    want = jbudget.allocate_rank_masks([jnp.asarray(g) for g in grams],
                                       BUDGET, RANK)
    got = budget.allocate_rank_masks([_t(g) for g in grams], BUDGET, RANK)
    for g, w, gram in zip(got, want, grams):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # prefix masks
        assert (g[:, 1:] <= g[:, :-1]).all()
        _close(budget.masked_identity_pad(_t(gram), g),
               jbudget.masked_identity_pad(jnp.asarray(gram), w))


@pytest.mark.parametrize("name", POLICIES)
def test_build_hck_policy_budget_matches_reference(builds, name):
    jf, f = builds[name]
    _factors_close(f, jf)
    assert f.ranks == jf.ranks
    assert f.ranks.total <= BUDGET and f.ranks.min >= 8
    assert f.ranks.min < f.ranks.max            # a ragged allocation


def test_ranks_summary_unbudgeted(problem):
    f = hck.build_hck(_t(problem[0]), levels=LEVELS, rank=RANK,
                      kernel=BaseKernel(),
                      generator=torch.Generator().manual_seed(1))
    assert f.rank_mask is None
    assert tuple(f.ranks) == (RANK, RANK, RANK * NODES)


def test_shared_landmarks_and_pca_match_reference(problem):
    x, _, _, key = problem
    jk, k = JKernel("gaussian", SIGMA, JITTER), BaseKernel("gaussian", SIGMA,
                                                           JITTER)
    jf = jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK, key=key,
                        kernel=jk, config=XLA, method="pca",
                        shared_landmarks=True)
    f = hck.build_hck(_t(x), levels=LEVELS, rank=RANK, kernel=k,
                      method="pca", shared_landmarks=True,
                      landmark_index=[d["index"] for d in policy_draws(
                          key, N, LEVELS, RANK, "uniform")])
    # the PCA directions are computed, not injected
    for got, want in zip(f.tree.directions, jf.tree.directions):
        _close(got, want)
    _factors_close(f, jf)
    assert all(torch.equal(lm, f.landmarks[0].expand_as(lm))
               for lm in f.landmarks)


# ---------------------------------------------------------------------------
# The sweep's policy axis
# ---------------------------------------------------------------------------

def test_replan_policy_matches_build_sweep_plan(problem):
    """Replanning with policy p equals planning with p: with the same
    generator state in the port, with the reference's draws against the
    reference's plan."""
    x, _, _, key = problem
    src = hck.build_sweep_plan(_t(x), levels=LEVELS, rank=RANK, device="cpu",
                               generator=torch.Generator().manual_seed(3))
    for name in POLICIES:
        fresh = hck.build_sweep_plan(
            _t(x), levels=LEVELS, rank=RANK, device="cpu", policy=name,
            generator=torch.Generator().manual_seed(3))
        re = hck.replan_policy(src, rank=RANK, policy=name,
                               generator=torch.Generator().manual_seed(3))
        for field in ("landmarks", "lm_self", "lm_cross"):
            assert all(torch.equal(a, b) for a, b in zip(
                getattr(re, field), getattr(fresh, field)))
        assert torch.equal(re.leaf_cross, fresh.leaf_cross)
    name = "leverage"
    jsrc = jhck.build_sweep_plan(jnp.asarray(x), levels=LEVELS, rank=RANK,
                                 key=key)
    jre = jhck.replan_policy(jsrc, rank=RANK, key=key, policy=name,
                             config=XLA)
    psrc = hck.build_sweep_plan(
        _t(x), levels=LEVELS, rank=RANK, device="cpu",
        directions=[_t(v) for v in jsrc.tree.directions],
        landmark_index=[d["index"] for d in policy_draws(
            key, N, LEVELS, RANK, "uniform")])
    pre = hck.replan_policy(psrc, rank=RANK, policy=name,
                            policy_draws=policy_draws(key, N, LEVELS, RANK,
                                                      name))
    for field in ("landmarks", "lm_self", "lm_cross"):
        for got, want in zip(getattr(pre, field), getattr(jre, field)):
            _close(got, want)
    _close(pre.leaf_cross, jre.leaf_cross)


def test_sweep_factors_budget_matches_reference_and_build_hck(problem,
                                                               builds):
    x, _, _, key = problem
    name = "leverage"
    jf = builds[name][0]
    draws = dict(directions=[_t(v) for v in jf.tree.directions],
                 policy_draws=policy_draws(key, N, LEVELS, RANK, name))
    plan = hck.build_sweep_plan(_t(x), levels=LEVELS, rank=RANK, device="cpu",
                                policy=name, **draws)
    jplan = jhck.build_sweep_plan(jnp.asarray(x), levels=LEVELS, rank=RANK,
                                  key=key, policy=name, config=XLA)
    for sg in (0.7, SIGMA):
        fs = hck.sweep_factors(plan, BaseKernel("gaussian", sg, JITTER),
                               rank_budget=BUDGET)
        jfs = jhck.sweep_factors(jplan, JKernel("gaussian", sg, JITTER),
                                 XLA, rank_budget=BUDGET)
        _factors_close(fs, jfs)
    _factors_close(fs, builds[name][1])         # == build_hck at sigma 1.5


# ---------------------------------------------------------------------------
# krr.fit and a budgeted model carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted(problem):
    """The reference's k-means + budget fit, and the port's on its draws.
    n = 512 fills the tree: padding rows (grid points plus noise) would
    make near-duplicate pairs whose medoid round-off decides."""
    x, y, q, key = problem
    jm = jkrr.fit(jnp.asarray(x), jnp.asarray(y),
                  kernel=JKernel("gaussian", SIGMA, JITTER), lam=LAM,
                  rank=RANK, leaf_size=64, key=key, solve_config=XLA,
                  landmarks="kmeans", rank_budget=BUDGET)
    _, kbuild = jax.random.split(key)
    m = krr.fit(
        x, y, kernel=BaseKernel("gaussian", SIGMA, JITTER), lam=LAM,
        rank=RANK, leaf_size=64, device="cpu", landmarks="kmeans",
        rank_budget=BUDGET,
        directions=[_t(v) for v in jm.factors.tree.directions],
        policy_draws=policy_draws(kbuild, N, LEVELS, RANK, "kmeans"))
    return jm, m, q


def test_fit_policy_budget_matches_reference(fitted):
    jm, m, q = fitted
    _factors_close(m.factors, jm.factors)
    _close(m.alpha, jm.alpha, 1e-8)
    _close(m.predict(_t(q)), jm.predict(jnp.asarray(q)), 1e-8)
    assert m.factors.ranks.total <= BUDGET


def test_budgeted_model_carried_across(fitted):
    jm, _, q = fitted
    arrays = flatten_model(jm.factors, jm.plan, jm.alpha)
    arrays.update({f"rank_mask/{lvl}": np.asarray(mk)
                   for lvl, mk in enumerate(jm.factors.rank_mask)})
    cm = convert.regressor_from_arrays(arrays, kernel="gaussian", sigma=SIGMA,
                                       jitter=JITTER, squeeze=True, lam=LAM,
                                       device="cpu")
    assert cm.factors.ranks == jm.factors.ranks
    _close(cm.predict(_t(q)), jm.predict(jnp.asarray(q)), 1e-10)
