"""The port's KRR training launcher (repro_torch.launch.train) and its
large-scale example (repro_torch.examples.large_scale_krr), run in process
on the CPU at n 512, d 3, rank 8: each mode prints the reference's line,
the in-memory and streamed fits give the same model, and the parts not yet
ported raise naming their ROADMAP item."""
import re

import pytest
import torch

from repro_torch.examples import large_scale_krr
from repro_torch.launch import train

BASE = ["--task", "krr", "--device", "cpu", "--n", "512", "--d", "3",
        "--rank", "8"]


@pytest.fixture(scope="module")
def fits():
    """The in-memory and the streamed fit of the same data and seed."""
    return {mode: train.main(BASE + extra)
            for mode, extra in (("in-memory", []), ("streaming",
                                                    ["--stream",
                                                     "--leaf-batch", "5"]))}


@pytest.mark.parametrize("mode", ["in-memory", "streaming"])
def test_fit_prints_the_reference_line(fits, mode, capsys):
    out = fits[mode]
    assert out["mode"] == mode and out["fit_s"] > 0
    assert 0 < out["train_rel_err"] < 0.2
    train.main(BASE + (["--stream"] if mode == "streaming" else []))
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(
        rf"krr n=512 d=3 rank=8 backend=auto \({mode}\): fit [0-9.]+ s "
        r"\([0-9,]+ points/s\), train rel-err [0-9.]{6}", line), line


def test_in_memory_and_streamed_fits_agree(fits):
    a, b = fits["in-memory"], fits["streaming"]
    assert f"{a['train_rel_err']:.4f}" == f"{b['train_rel_err']:.4f}"
    fa, fb = a["model"].factors, b["model"].factors
    assert torch.equal(fa.tree.perm, fb.tree.perm)
    assert torch.equal(fa.x_sorted, fb.x_sorted)
    for la, lb in zip(fa.landmarks, fb.landmarks):
        assert torch.equal(la, lb)
    gap = (a["model"].alpha - b["model"].alpha).abs().max()
    assert gap <= 1e-4 * a["model"].alpha.abs().max()


def test_update(capsys):
    out = train.main(BASE + ["--update", "48"])
    assert out["update_k"] >= 1 and out["update_rel_err"] < 0.2
    assert out["updated"].factors.leaf_size == 8 + out["update_k"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.match(r"krr-update \+48 points: [0-9.]+ s \([0-9,]+ inserts/s "
                    r"vs full fit [0-9,]+ points/s\), k=\d+/leaf, resid "
                    r"\S+, rebuild=(True|False), train rel-err [0-9.]{6}$",
                    lines[-1]), lines[-1]


def test_exact_cg(capsys):
    out = train.main(BASE + ["--solver", "exact-cg"])
    assert out["iterations"] > 0 and out["residual"] <= 1e-4
    assert out["train_rel_err"] < 0.2
    line = capsys.readouterr().out.strip()
    assert line.startswith("krr-exact n=512 d=3 rank=8 solver=exact-cg "
                           "backend=auto: fit ")
    assert f"in {out['iterations']} iterations" in line


def test_grid(capsys):
    out = train.main(BASE + ["--grid", "--sigmas", "1,2", "--lams",
                             "1e-3,1e-2", "--val", "128"])
    assert len(out["surface"]) == 2 and len(out["surface"][0]) == 2
    assert out["val_rel_err"] == pytest.approx(
        min(min(row) for row in out["surface"]), abs=1e-6)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("sweep n=512 rank=8 grid=2x2 backend=auto: ")
    assert lines[1].startswith("  sigma=1 ") and len(lines) == 4
    assert lines[3] == (f"best: sigma={out['sigma']} lam={out['lam']} "
                        f"val-relerr {out['val_rel_err']:.4f}")


@pytest.mark.parametrize("extra, item", [
    (["--task", "lm"], "A16b"),
    (BASE[2:] + ["--task", "krr", "--mesh", "4"], "A14"),
    (BASE + ["--precision", "bf16"], None)], ids=["lm", "mesh", "bf16"])
def test_unported_parts_raise(extra, item, capsys):
    """--task lm and --mesh raise naming their ROADMAP item; --precision
    bf16 (A15a) runs, at the reference's bf16 convention (jitter 1e-4,
    lambda 1e-1), and prints the reference's line."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            train.main(extra)
        return
    out = train.main(extra)
    m = out["model"]
    assert out["precision"] == "bf16" and m.solve_config.precision == "bf16"
    assert m.lam == 1e-1 and m.kernel.jitter == 1e-4
    assert m.alpha.dtype == torch.float32 and 0 < out["train_rel_err"] < 0.3
    assert capsys.readouterr().out.startswith(
        "krr n=512 d=3 rank=8 backend=auto (in-memory): fit ")


def test_example_in_memory_and_streamed(capsys):
    argv = ["--device", "cpu", "--n", "512", "--d", "3", "--rank", "8"]
    a = large_scale_krr.main(argv)
    b = large_scale_krr.main(argv + ["--stream", "--leaf-batch", "7"])
    assert a["accuracy"] == b["accuracy"] > 0.6
    out = capsys.readouterr().out
    assert out.count("n=512 d=3 r=8  levels=6") == 2
    assert out.count(f"test accuracy: {a['accuracy']:.4f}") == 2
