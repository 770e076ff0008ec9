"""Port parity: kernel PCA (repro_torch.core.kpca).

The reference (float64) and the port's plain PyTorch path on the CPU
embed the same factors -- carried across by ``repro_torch.convert`` --
from the same start block (the reference's ``jax.random.normal`` draw,
handed to the port as ``v0``).  ``torch.linalg.eigh`` and
``jnp.linalg.eigh`` may return eigenvectors of opposite sign, so
embeddings and transforms are compared column by column up to sign.
Tolerance 1e-10 relative unless a line says otherwise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_oos import flatten_model

from repro.core import hck as jhck
from repro.core import kpca as jkpca
from repro.core.kernels_fn import BaseKernel as JKernel
from repro_torch import convert
from repro_torch.core import hck, kpca
from repro_torch.core.kernels_fn import BaseKernel

N, D, RANK, LEVELS = 512, 3, 8, 5
SIGMA, JITTER, DIM, ITERS = 1.5, 1e-10, 3, 100
#: flatten_model's plan fields, empty: only the factors are carried
NO_PLAN = types.SimpleNamespace(c=(), w_leaf=None, c_tilde=None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _signs(got, want):
    """Per-column signs that align the columns of ``got`` with ``want``."""
    dots = np.sum(np.asarray(got) * np.asarray(want), axis=0)
    return torch.from_numpy(np.where(dots < 0, -1.0, 1.0))


@pytest.fixture(scope="module")
def models(f64):
    """(reference factors, port factors, reference model, port model, the
    reference's start block, queries)."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((N, D))
    jf = jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK,
                        key=jax.random.PRNGKey(41),
                        kernel=JKernel("gaussian", SIGMA, JITTER))
    f = convert.factors_from_arrays(flatten_model(jf, NO_PLAN),
                                    device="cpu")
    key = jax.random.PRNGKey(42)
    v0 = jax.random.normal(key, (N, DIM + 4), dtype=jnp.float64)
    jm = jkpca.kpca_fit(jf, JKernel("gaussian", SIGMA, JITTER), DIM,
                        iters=ITERS, key=key)
    m = kpca.kpca_fit(f, BaseKernel("gaussian", SIGMA, JITTER), DIM,
                      iters=ITERS, v0=_t(v0), device="cpu")
    return jf, f, jm, m, rng.standard_normal((30, D))


def test_kpca_embedding_matches_reference(models):
    _, _, jm, m, _ = models
    _close(m.evals, jm.evals)
    sign = _signs(m.embedding, jm.embedding)
    _close(m.embedding * sign, jm.embedding)
    # the eigenvectors of the centered operator are orthogonal to 1, so
    # V^T 1 is round-off around zero on both sides: held absolutely
    np.testing.assert_allclose(m.v1 * sign, jm.v1, rtol=0, atol=1e-12)
    _close(m.a0 * sign, jm.a0)


def test_kpca_transform_matches_reference(models):
    _, _, jm, m, q = models
    sign = _signs(m.embedding, jm.embedding)
    _close(m.transform(_t(q)) * sign, jm.transform(jnp.asarray(q)), 1e-9)
    assert m.transform(_t(q)).shape == (30, DIM)


def test_kpca_against_dense_oracle_and_training_points(models):
    """The embedding spans the dense oracle's top eigenvectors
    (alignment_difference, the Fig. 8 metric), and the transform of the
    training points gives back their embedding."""
    _, f, _, m, _ = models
    emb_d, evals_d = kpca.kpca_embed_dense(kpca.center(hck.to_dense(f)), DIM)
    _close(m.evals, evals_d, 1e-8)
    assert float(kpca.alignment_difference(emb_d, m.embedding)) < 1e-6
    _close(m.transform(f.x_sorted[:64]), m.embedding[:64], 1e-6)


def test_kpca_oracles_match_reference(models):
    jf, f, _, _, _ = models
    k = hck.to_dense(f)
    _close(kpca.center(k), jkpca.center(jhck.to_dense(jf)))
    emb, evals = kpca.kpca_embed_dense(kpca.center(k), DIM)
    jemb, jevals = jkpca.kpca_embed_dense(jkpca.center(jhck.to_dense(jf)),
                                         DIM)
    _close(evals, jevals)
    _close(emb * _signs(emb, jemb), jemb, 1e-8)
    u = np.random.default_rng(43).standard_normal((N, DIM))
    ut = u + 1e-3 * np.random.default_rng(44).standard_normal((N, DIM))
    _close(kpca.alignment_difference(_t(u), _t(ut)),
           jkpca.alignment_difference(jnp.asarray(u), jnp.asarray(ut)))


def test_kpca_embed_from_generator(models):
    _, f, _, m, _ = models
    emb, evals = kpca.kpca_embed(f, DIM, iters=ITERS,
                                 generator=torch.Generator().manual_seed(5))
    _close(evals, m.evals, 1e-8)
    assert float(kpca.alignment_difference(m.embedding, emb)) < 1e-6
    with pytest.raises(ValueError, match="v0"):
        kpca.kpca_embed(f, DIM, v0=torch.zeros(N, DIM))


def test_kpca_carried_across(models):
    """A reference KPCA model carried across by convert transforms as the
    reference does (same eigenvector signs: the arrays are its own)."""
    jf, _, jm, _, q = models
    arrays = flatten_model(jf, NO_PLAN)
    arrays.update({k: np.asarray(getattr(jm, k))
                   for k in ("embedding", "evals", "v1", "a0")})
    cm = convert.kpca_from_arrays(arrays, kernel="gaussian", sigma=SIGMA,
                                  jitter=JITTER, device="cpu")
    _close(cm.transform(_t(q)), jm.transform(jnp.asarray(q)), 1e-9)


def test_kpca_fit_runs_on_the_card_by_default(models, monkeypatch):
    _, f, _, _, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        kpca.kpca_fit(f, BaseKernel(), DIM)
