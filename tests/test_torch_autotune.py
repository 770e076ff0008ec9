"""Port parity: the tuning and launch surface (ROADMAP A15b) --
``repro_torch.kernels.autotune`` (the tile database), ``repro_torch.utils.
roofline``, ``repro_torch.launch.platform`` and the quickstart example.

Every database lives under the test's ``tmp_path`` (``REPRO_TILE_DB``
through ``monkeypatch``) and the process's cached copy is dropped after
each test.  On the CPU the sweeps time the plain versions; their "cuda"
candidates are recorded with the error the port's rule gives them.  The
wrappers' consults are checked on their card path with the device check
and the ctypes launch replaced by a recorder.  The quickstart's readings
are held against the reference's quickstart steps on the same data, with
the reference's random draws injected.
"""
import json
import math
import os

import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.utils import roofline as jroofline
from repro_torch import device as _device
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.build_stage import ops as bops
from repro_torch.kernels.oos_stage import ops as oops
from repro_torch.kernels.registry import SolveConfig, resolve_backend
from repro_torch.launch.platform import setup_platform
from repro_torch.testing import faultinject as fi
from repro_torch.utils import roofline

STAGES = ("leaf_matvec", "leaf_solve", "leaf_project", "leaf_factor",
          "build_gram", "build_gram_dist", "build_cross", "build_cross_dist",
          "oos_local", "oos_walk", "kernel_matvec", "pairwise_kernel")


@pytest.fixture
def tile_db(tmp_path, monkeypatch):
    """A throwaway database file for this test."""
    path = tmp_path / "tile_db.json"
    monkeypatch.setenv("REPRO_TILE_DB", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset_db()
    yield path
    autotune.reset_db()


@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args)."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    return calls


def _put(stage, dtype, shape, **rec):
    """A record in the database, keyed as a sweep keys it."""
    db = autotune.get_db()
    key = autotune.bucket_key(stage, autotune.device_kind(), dtype,
                              **autotune.key_shape(stage, **shape))
    db.put(key, {"stage": stage, **rec})
    db.save()
    autotune.reset_db()
    return key


# ---------------------------------------------------------------------------
# the roofline and the keys: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_stage_cost_equals_reference(stage):
    for batch, n0, r, k, d, itemsize in [(1, 8, 0, 1, 0, 4),
                                         (8, 256, 16, 2, 4, 4),
                                         (4096, 128, 128, 7, 54, 4),
                                         (3, 100, 33, 5, 90, 8),
                                         (2, 64, 64, 1, 3, 2)]:
        shape = dict(batch=batch, n0=n0, r=r, k=k, d=d, itemsize=itemsize)
        assert roofline.stage_cost(stage, **shape) == \
            jroofline.stage_cost(stage, **shape), (stage, shape)
    rec = roofline.stage_roofline(stage, 1e-3, n0=64, r=16, k=2, d=4,
                                  hw=roofline.HW_MODELS["gpu"])
    want = jroofline.stage_roofline(stage, 1e-3, n0=64, r=16, k=2, d=4,
                                    hw=roofline.HW_MODELS["gpu"])
    assert rec == want
    with pytest.raises(ValueError, match="no cost model"):
        roofline.stage_cost("nope", n0=8)


def test_bucket_key_equals_reference():
    for stage in STAGES:
        for dev in ("NVIDIA_H100_80GB_HBM3", "cpu"):
            for dtype in ("float32", "float64", "bfloat16"):
                for n0, r, k, d in [(100, 17, 3, 5), (128, 128, 7, 54),
                                    (0, 0, 1, 0), (4097, 1, 160, 90)]:
                    assert autotune.bucket_key(
                        stage, dev, dtype, n0=n0, r=r, k=k, d=d) == \
                        jautotune.bucket_key(stage, dev, dtype, n0=n0, r=r,
                                             k=k, d=d)
    assert autotune.db_path() != jautotune.db_path() or \
        "REPRO_TILE_DB" in os.environ
    assert set(autotune.DEFAULT_STAGES) == set(jautotune.DEFAULT_STAGES)
    assert roofline.HW_MODELS["gpu"] == {"peak_flops": 495e12,
                                         "hbm_bw": 3.35e12,
                                         "link_bw": 450e9}


# ---------------------------------------------------------------------------
# the database's life
# ---------------------------------------------------------------------------

def test_sweep_then_cache_hit_roundtrip(tile_db):
    rec = autotune.autotune_stage("leaf_matvec", n0=32, r=8, k=1, d=4,
                                  batch=2, repeats=1, device="cpu")
    assert rec["cached"] is False and rec["backend"] == "torch"
    assert rec["best_s"] > 0 and rec["platform"] == "cpu"
    assert [c["backend"] for c in rec["candidates"]] == ["torch", "cuda"]
    assert "CUDA tensors only" in rec["candidates"][1]["error"]
    assert os.path.exists(tile_db), "the sweep persists the database"
    blob = json.loads(tile_db.read_text())
    assert blob["version"] == 1 and "torch" in blob
    assert list(blob["entries"]) == [autotune.bucket_key(
        "leaf_matvec", "cpu", "float32", n0=32, r=8, k=1, d=4)]

    autotune.reset_db()                       # read again from the file
    hit = autotune.autotune_stage("leaf_matvec", n0=32, r=8, k=1, d=4,
                                  batch=2, repeats=1, device="cpu")
    assert hit["cached"] is True
    assert {k: v for k, v in hit.items() if k != "cached"} == \
        {k: v for k, v in rec.items() if k != "cached"}
    near = autotune.autotune_stage("leaf_matvec", n0=30, r=7, k=1, d=3,
                                   batch=2, repeats=1, device="cpu")
    assert near["cached"] is True             # one power-of-two bucket
    # the oos stages key r as 0, as their wrappers look them up
    o = autotune.autotune_stage("oos_local", n0=128, r=128, k=7, d=54,
                                repeats=1, device="cpu")
    assert o["bucket"]["r"] == 0 and (o["bucket"]["k"], o["bucket"]["d"]) \
        == (8, 64)
    assert autotune.candidates("oos_local", n0=128, r=0, k=8, d=64) == \
        [16, 32, 64, 128]
    assert autotune.candidates("build_cross", n0=128, r=128, k=128, d=64,
                               itemsize=4) == []
    assert autotune.candidates("build_cross", n0=128, r=128, k=128, d=64,
                               itemsize=8) == sorted(bops.row_tiles(128, 8))


def test_cross_candidates_list_the_panel_plan_at_rank_256():
    """Past rank 128 the float64 cross stages take the panel form, whose
    one row height is their candidate (its block fits the shared memory);
    past rank 256, and in float32, nothing."""
    for stage, smem in (("build_cross", bops.cross_smem),
                        ("build_cross_dist", bops.cross_dist_smem)):
        got = autotune.candidates(stage, n0=512, r=256, k=256, d=54,
                                  itemsize=8)
        assert got == [bops.PANEL_ROWS[8]] == bops.row_tiles(256, 8, smem)
        assert bops.cross_panel_smem(8) <= _build.SMEM_MAX
        assert autotune.candidates(stage, n0=512, r=257, k=257, d=54,
                                   itemsize=8) == []
        assert autotune.candidates(stage, n0=512, r=256, k=256, d=54,
                                   itemsize=4) == []


def test_measured_block_steers_the_oos_plan_and_cross_row_tile(
        tile_db, fake_card, monkeypatch):
    plans = []
    plan0 = oops.plan
    monkeypatch.setattr(oops, "plan",
                        lambda *a, **kw: plans.append(plan0(*a, **kw))
                        or plans[-1])
    g = torch.Generator().manual_seed(0)
    pts = torch.randn((4, 64, 5), generator=g)
    w = torch.randn((4, 64, 2), generator=g)
    q = torch.randn((9, 5), generator=g)
    idx = torch.arange(9) % 4
    oops.oos_contract(pts, w, q, idx, idx)
    cold = plans[-1]["rows"]
    assert cold == 64                          # all rows fit: the cold plan
    _put("oos_local", "float32", dict(n0=64, r=16, k=2, d=5),
         cuda_block=16, block=None)
    oops.oos_contract(pts, w, q, idx, idx)
    assert plans[-1]["rows"] == 16             # the measured block steers
    oops.oos_contract(pts, w, q, idx, idx, leaf_block=32)
    assert plans[-1]["rows"] == 32             # the caller's block wins
    assert len(fake_card) == 3

    pts8, lm8 = torch.randn((2, 40, 5), dtype=torch.float64), \
        torch.randn((2, 8, 5), dtype=torch.float64)
    linv = torch.eye(8, dtype=torch.float64).expand(2, 8, 8).contiguous()
    dist = torch.rand((2, 40, 8), dtype=torch.float64)
    fake_card.clear()
    bops.build_cross(pts8, lm8, linv)
    bops.build_cross_dist(dist, linv)
    assert (fake_card[0][2][4], fake_card[1][2][3]) == (64, 64)   # cold
    _put("build_cross", "float64", dict(n0=40, r=8, k=7, d=5),
         cuda_block=16)
    _put("build_cross_dist", "float64", dict(n0=40, r=8, k=7, d=5),
         cuda_block=32)
    fake_card.clear()
    bops.build_cross(pts8, lm8, linv)
    bops.build_cross_dist(dist, linv)
    bops.build_cross(pts8, lm8, linv, row_tile=128)
    assert (fake_card[0][2][4], fake_card[1][2][3], fake_card[2][2][4]) \
        == (16, 32, 128)
    # a measured tile past the shared memory is not taken: the plan runs
    _put("build_cross", "float64", dict(n0=40, r=8, k=7, d=5),
         cuda_block=96)
    fake_card.clear()
    bops.build_cross(pts8, lm8, linv)
    assert fake_card[0][2][4] == 64
    with pytest.raises(ValueError, match="row tile 96"):
        bops.build_cross(pts8, lm8, linv, row_tile=96)
    with pytest.raises(ValueError, match="float64 tile"):
        bops.build_cross(pts8.float(), lm8.float(), linv.float(),
                         row_tile=16)


def test_autotune_disabled_turns_lookups_off(tile_db, monkeypatch):
    shape = dict(n0=64, r=0, k=2, d=5)
    _put("oos_local", "float32", shape, cuda_block=16)
    assert autotune.lookup_block("oos_local", **shape) == 16
    assert oops.measured_block((64,), 5, 2, 4) == 16
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert not autotune.lookups_enabled()
    assert autotune.lookup_block("oos_local", **shape) is None
    assert oops.measured_block((64,), 5, 2, 4) is None
    assert autotune.calibrated_peaks("cpu") is None


def test_consult_answers_repeat_from_memory_until_a_put(tile_db,
                                                        monkeypatch):
    shape = dict(n0=64, r=0, k=2, d=5)
    _put("oos_local", "float32", shape, cuda_block=16)
    assert oops.measured_block((64,), 5, 2, 4) == 16
    db = autotune.get_db()
    assert list(db.answers.values()) == [16]
    calls = []
    monkeypatch.setattr(autotune, "lookup_block",
                        lambda *a, **kw: calls.append(a) or 99)
    assert oops.measured_block((64,), 5, 2, 4) == 16 and not calls
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")   # still read on every call
    assert oops.measured_block((64,), 5, 2, 4) is None
    monkeypatch.delenv("REPRO_AUTOTUNE")
    db.put("any", {})                           # a put forgets the answers
    assert not db.answers
    assert oops.measured_block((64,), 5, 2, 4) == 99 and calls


def test_corrupt_db_degrades_and_next_save_repairs(tile_db):
    shape = dict(n0=64, r=0, k=2, d=5)
    _put("oos_local", "float32", shape, cuda_block=16)
    path = fi.corrupt_tile_db()
    assert path == str(tile_db)
    db = autotune.get_db()
    assert db.corrupt and db.entries == {}
    # every consult degrades to the plan, none raises
    assert autotune.lookup_block("oos_local", **shape) is None
    assert oops.measured_block((64,), 5, 2, 4) is None
    assert bops.measured_row_tile("build_cross", 40, 8, 5, 8) is None
    assert oops.plan((64,), 5, 2, 4, oops.measured_block((64,), 5, 2, 4)) \
        == oops.plan((64,), 5, 2, 4)
    db.put("probe", {"block": 32})
    db.save()
    assert not db.corrupt
    autotune.reset_db()
    healed = autotune.get_db()
    assert not healed.corrupt and healed.get("probe") == {"block": 32}
    # a file that is JSON but not a database is corrupt too
    tile_db.write_text('{"entries": [1, 2]}')
    autotune.reset_db()
    assert autotune.get_db().corrupt


def test_calibrated_peaks_aggregate_by_platform(tile_db):
    db = autotune.get_db()
    for i, (plat, f, b) in enumerate([("gpu", 1e12, 3e11), ("gpu", 3e12, 1e11),
                                      ("cpu", 5e9, 2e9)]):
        db.put(f"k{i}", {"platform": plat,
                         "rates": {"flops_per_s": f, "bytes_per_s": b}})
    db.save()
    autotune.reset_db()
    assert autotune.calibrated_peaks("gpu") == {"flops_per_s": 3e12,
                                                "bytes_per_s": 3e11}
    assert autotune.calibrated_peaks("cpu") == {"flops_per_s": 5e9,
                                                "bytes_per_s": 2e9}
    assert autotune.calibrated_peaks("tpu") is None
    hw = roofline.hw_model("gpu")
    assert hw["calibration"] == "measured (tile_db)"
    assert (hw["peak_flops"], hw["hbm_bw"]) == (3e12, 3e11)
    nominal = roofline.hw_model("gpu", calibrate=False)
    assert nominal["calibration"] == "nominal"
    assert nominal["peak_flops"] == 495e12


def test_auto_backend_follows_the_device_whatever_the_winner(tile_db):
    shape = dict(n0=128, r=16, k=2, d=0)
    _put("leaf_matvec", "float32", shape, backend="cuda", block=None)
    _put("kernel_matvec", "float32", dict(n0=128, r=16, k=2, d=4),
         backend="torch", block=None)
    assert autotune.lookup_backend("leaf_matvec", dtype=torch.float32,
                                   **shape) == "cuda"
    t = torch.zeros((4, 128, 128))
    assert resolve_backend(SolveConfig(), "leaf_matvec", t) == "torch"
    assert resolve_backend(None, "kernel_matvec", t) == "torch"
    recs = list(autotune.get_db().entries.values())
    assert [r["stage"] for r in autotune.torch_winners(recs)] == \
        ["kernel_matvec"]


# ---------------------------------------------------------------------------
# the launch surface
# ---------------------------------------------------------------------------

def test_setup_platform_record(monkeypatch):
    monkeypatch.setattr(_device, "_DEFAULT", _device._DEFAULT)
    monkeypatch.setenv("REPRO_PLATFORM", "cpu")
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    rec = setup_platform()
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["host_devices"] == 4 and rec["flags"] == []
    assert "no XLA" in rec["xla_flags"]
    assert _device.resolve(None) == torch.device("cpu")
    assert setup_platform("cpu", 2)["host_devices"] == 2   # arguments win
    with pytest.raises(ValueError, match="platform 'tpu'"):
        setup_platform("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            setup_platform("gpu")
        assert _device.default() == "cpu"


def test_quickstart_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu", "--n", "512"])
    text = capsys.readouterr().out
    for line in ("HCK-KRR", "Nystrom", "RFF", "independent", "exact (n^3)",
                 "GP posterior var", "GP log marginal likelihood"):
        assert line in text
    errs = [out[k] for k in ("hck", "nystrom", "rff", "independent",
                             "exact")]
    assert all(math.isfinite(e) and 0 < e < 1.5 for e in errs)
    assert out["exact"] <= min(errs) + 1e-12     # the dense solve is best
    assert all(0 < v < 1.5 for v in out["gp_var"])
    assert math.isfinite(out["gp_lml"])


def test_quickstart_matches_the_reference(f64, capsys):
    """The reference quickstart's steps (its seeds 7 to 11) and the port's
    :func:`quickstart.run` on the same float64 data, n 512, with the
    reference's draws injected: every relative error, the GP variances and
    the log marginal likelihood within 1e-8 relative."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from test_torch_build import landmark_draws
    from test_torch_fit import reference_draws

    from repro.core import baselines as jbaselines
    from repro.core import gp as jgp
    from repro.core import krr as jkrr
    from repro.core.kernels_fn import BaseKernel as JKernel
    from repro_torch.examples import quickstart

    rng = np.random.default_rng(60)
    n, d, rank, lam = 512, 8, 64, 1e-2
    x, xt = rng.random((n, d)), rng.random((1024, d))
    f = lambda a: np.sin(6 * a[:, 0]) * np.cos(4 * a[:, 1]) + a[:, 2] ** 2
    y, yt = f(x) + 0.05 * rng.standard_normal(n), f(xt)
    jx, jy, jxt, jyt = map(jnp.asarray, (x, y, xt, yt))
    jk, key = JKernel("gaussian", sigma=0.7), jax.random.PRNGKey
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731

    m = jkrr.fit(jx, jy, kernel=jk, lam=lam, rank=rank, key=key(7))
    ny = jbaselines.fit_nystrom(jx, jy, kernel=jk, lam=lam, rank=rank,
                                key=key(8))
    rf = jbaselines.fit_rff(jx, jy, kernel=jk, lam=lam, rank=rank,
                            key=key(9))
    ind = jbaselines.fit_independent(jx, jy, kernel=jk, lam=lam, levels=6,
                                     key=key(10))
    ex = jbaselines.fit_exact(jx, jy, kernel=jk, lam=lam)
    g = jgp.fit_gp(jx, jy, kernel=jk, noise=lam, rank=rank, levels=3,
                   key=key(11))
    rel = lambda p: float(jkrr.relative_error(p, jyt))   # noqa: E731
    want = {"hck": rel(m.predict(jxt)), "nystrom": rel(ny.predict(jxt)[:, 0]),
            "rff": rel(rf.predict(jxt)[:, 0]), "independent": rel(
                ind.predict(jxt)), "exact": rel(ex(jxt)),
            "gp_var": np.asarray(g.posterior_var(jxt[:4])),
            "gp_lml": float(g.log_marginal_likelihood(
                jy[g.factors.tree.perm]))}

    dirs = lambda tree: [t(v) for v in tree.directions]   # noqa: E731
    draws = {
        "hck": dict(directions=dirs(m.factors.tree),
                    **reference_draws(key(7), x, rank, 3, rank)),
        "nystrom": dict(landmark_index=t(
            jax.random.permutation(key(8), n)[:rank])),
        "rff": dict(omega=t(rf.omega), bias=t(rf.bias)),
        "independent": dict(directions=dirs(ind.tree)),
        "gp": dict(directions=dirs(g.factors.tree),
                   landmark_index=landmark_draws(key(11), n, 3, rank))}
    got = quickstart.run(*map(torch.from_numpy, (x, y, xt, yt)),
                         device="cpu", draws=draws)
    assert "GP log marginal likelihood" in capsys.readouterr().out
    for k in ("hck", "nystrom", "rff", "independent", "exact", "gp_lml"):
        assert got[k] == pytest.approx(want[k], rel=1e-8), k
    np.testing.assert_allclose(got["gp_var"], want["gp_var"], rtol=1e-8)
    # the readings discriminate: the dense solve is the best fit, and the
    # structured one is nearer it than the independent blocks
    assert want["exact"] < want["hck"] < want["independent"]
