"""Port parity: partitioning and routing (repro_torch.core.partition).

The tree order (``perm``, ``x_sorted``) and the routed leaves must match the
JAX reference exactly.  Directions are injected (random draws do not cross
frameworks); thresholds are midpoints of projections summed in another
order, so they are held to a few ulp of the projection scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro_torch.core import partition

EPS64 = np.finfo(np.float64).eps


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(x, levels, seed=1):
    return jpart.build_partition(jnp.asarray(x), levels, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n,d,levels", [(512, 3, 5), (64, 1, 1), (256, 4, 3)])
def test_build_partition_with_injected_directions(f64, n, d, levels):
    x = np.random.default_rng(0).standard_normal((n, d))
    jx, jtree = _jtree(x, levels)
    xs, tree = partition.build_partition(
        _t(x), levels, directions=[_t(v) for v in jtree.directions])
    np.testing.assert_array_equal(tree.perm.numpy(), np.asarray(jtree.perm))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jx))
    scale = np.abs(x).max() * d
    for got, want in zip(tree.thresholds, jtree.thresholds):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=4 * EPS64 * scale)
    for got, want in zip(tree.directions, jtree.directions):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_and_group_by_leaf_match_reference_exactly(f64):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((512, 3))
    jx, jtree = _jtree(x, 5)
    tree = partition.PartitionTree(_t(jtree.perm),
                                   tuple(map(_t, jtree.directions)),
                                   tuple(map(_t, jtree.thresholds)))
    q = np.concatenate([rng.standard_normal((300, 3)), np.asarray(jx)[::7]])
    leaf = partition.route(tree, _t(q))
    jleaf = jpart.route(jtree, jnp.asarray(q))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    got = partition.group_by_leaf(leaf, tree.num_leaves)
    want = jpart.group_by_leaf(jleaf, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_by_leaf_is_stable():
    leaf = torch.tensor([3, 1, 3, 0, 1, 3, 0])
    order, counts, starts = partition.group_by_leaf(leaf, 4)
    assert order.tolist() == [3, 6, 1, 4, 0, 2, 5]
    assert counts.tolist() == [2, 2, 0, 3]
    assert starts.tolist() == [0, 2, 4, 4]


def test_pad_points_with_injected_draws_matches_reference(f64):
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((500, 3)), rng.standard_normal((500, 2))
    key = jax.random.PRNGKey(4)
    jxp, jyp, jmask = jpart.pad_points(jnp.asarray(x), jnp.asarray(y), 16, 5, key)
    # the reference's own draws, from the same key split
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (12,), 0, 500)
    noise = 1e-4 * jax.random.normal(k2, (12, 3), dtype=jnp.float64)
    xp, yp, mask = partition.pad_points(_t(x), _t(y), 16, 5, index=_t(idx),
                                        noise=_t(noise))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(yp.numpy(), np.asarray(jyp))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_pad_points_own_draws_and_limits():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(500, 3, dtype=torch.float64, generator=gen)
    xp, yp, mask = partition.pad_points(x, None, 16, 5, generator=gen)
    assert xp.shape == (512, 3) and yp is None and int(mask.sum()) == 500
    assert torch.equal(xp[:500], x)
    # every padding row is a jittered copy of a real row
    gap = (xp[500:, None, :] - x[None]).abs().sum(-1).min(dim=1).values
    assert float(gap.max()) < 1e-2
    exact = x[:256]
    same, _, mask = partition.pad_points(exact, None, 16, 4)
    assert same is exact and bool(mask.all())
    with pytest.raises(ValueError, match="levels >= 1"):
        partition.pad_points(x, None, 16, 0)
    with pytest.raises(ValueError, match="exceeds capacity"):
        partition.pad_points(x, None, 8, 5)


@pytest.mark.parametrize("levels", [1, 4, 6])
def test_own_draws_give_a_balanced_tree_that_routes_its_points(levels):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1024, 5, dtype=torch.float64, generator=gen)
    xs, tree = partition.build_partition(x, levels, generator=gen)
    assert sorted(tree.perm.tolist()) == list(range(1024))
    assert torch.equal(xs, x[tree.perm])
    for v in tree.directions:
        assert torch.allclose(v.norm(dim=-1), torch.ones(v.shape[0],
                                                         dtype=v.dtype))
    leaf = partition.route(tree, xs)
    n0 = 1024 >> levels
    assert torch.equal(leaf, torch.arange(1024) // n0)
