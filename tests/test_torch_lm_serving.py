"""Port parity: LM serving of the reduced zamba2-7b (``ServeSession``
prefill and decode, the transformer's prefill and decode steps, the model
zoo and the launcher) against the JAX reference.

The reference's parameters (``repro.models.transformer.init_params``,
float32 in the reduced config) carry across through
``repro_torch.convert.lm_params_from_arrays``; the prompts are
numpy-seeded int32 tokens.  The reference prefill is compiled once per
variant in a module fixture.  Compared: the prefill's last logits and its
caches (SSM state, conv cache, the shared block's K/V at the slots that
apply it: the port keeps only those), the HCK decode state the session
builds, and four decode steps of logits, all within 1e-4 of the largest
reference entry (float32 sums in another order through 3 layers; the HCK
state adds an 8 x 8 inverse of a jittered Gram).  The "full" variant
covers ``decode_attention`` and the exact shared K/V cache, as
tests/test_serving.py::test_decode_matches_full_forward_hybrid does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtf
from repro.models.model_zoo import make_decode_step as jmake_decode_step
from repro.models.model_zoo import make_prefill_step as jmake_prefill_step
from repro.serving.serve_loop import ServeSession as JServeSession
from repro_torch.configs import get_arch, get_shape
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention_backends as ab
from repro_torch.models import transformer as tf
from repro_torch.models.model_zoo import input_specs, make_prefill_step
from repro_torch.serving.serve_loop import ServeSession

B, SEQ, MAX_SEQ, STEPS = 2, 32, 64, 4
RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _variant(backend):
    cfg = jget_arch("zamba2-7b").reduced()
    pcfg = get_arch("zamba2-7b").reduced()
    if backend != "hck":
        cfg = dataclasses.replace(cfg, attn_backend=backend)
        pcfg = dataclasses.replace(pcfg, attn_backend=backend)
    return cfg, pcfg


@pytest.fixture(scope="module", params=["hck", "full"])
def run(request):
    """Per attention backend: the reference's prefill, session caches and
    decode logits, and the port's on the same weights and tokens."""
    cfg, pcfg = _variant(request.param)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    jparams = jtf.init_params(cfg, jax.random.PRNGKey(0))
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                   cfg=pcfg, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (B, SEQ)).astype(np.int32)

    jlogits, jcaches = jmake_prefill_step(cfg)(
        jparams, {"tokens": jnp.asarray(toks)})
    jsess = JServeSession(cfg, jparams, max_seq=MAX_SEQ)
    jsess.prefill({"tokens": jnp.asarray(toks)})
    jabsorbed = jax.tree.map(np.asarray, jsess.caches)
    jdecode = jax.jit(jmake_decode_step(cfg))
    feed = np.random.default_rng(4).integers(
        0, cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    jsteps, caches = [], jsess.caches
    for i in range(STEPS):
        lg, caches = jdecode(jparams, {
            "tokens": jnp.asarray(feed[i]), "caches": caches,
            "pos": jnp.asarray(SEQ + i, jnp.int32)})
        jsteps.append(np.asarray(lg))

    ptoks = torch.from_numpy(toks.astype(np.int64))
    logits, pcaches = make_prefill_step(pcfg)(params, {"tokens": ptoks})
    sess = ServeSession(pcfg, params, max_seq=MAX_SEQ)
    last = sess.prefill({"tokens": ptoks})
    absorbed = {k: (v if isinstance(v, torch.Tensor) else dict(v))
                for k, v in sess.caches.items()}
    absorbed = jax.tree.map(lambda t: t.clone(), absorbed)
    steps = []
    for i in range(STEPS):
        lg, sess.caches = tf.decode_step(
            params, pcfg, sess.caches,
            {"tokens": torch.from_numpy(feed[i].astype(np.int64))}, SEQ + i)
        steps.append(lg)
    return dict(cfg=cfg, pcfg=pcfg, jparams=jparams, params=params,
                toks=toks, jlogits=np.asarray(jlogits),
                jcaches=jax.tree.map(np.asarray, jcaches), logits=logits,
                caches=pcaches, last=last, jabsorbed=jabsorbed,
                absorbed=absorbed, jsteps=jsteps, steps=steps)


def test_prefill_logits_match_reference(run):
    _close(run["logits"][:, -1], run["jlogits"][:, -1])
    _close(run["last"], run["jlogits"][:, -1])
    _close(run["logits"], run["jlogits"])


def test_prefill_caches_match_reference(run):
    cfg, caches, jcaches = run["cfg"], run["caches"], run["jcaches"]
    assert len(caches) == len(jcaches) == 4
    _close(caches[0], jcaches[0])                          # SSM states
    _close(caches[1], jcaches[1])                          # conv caches
    every = cfg.shared_attn_every
    slots = np.arange(caches[2].shape[0]) * every
    assert caches[2].shape[0] == -(-cfg.n_layers // every)
    for port, ref in zip(caches[2:], jcaches[2:]):         # shared K / V
        _close(port, ref[slots])
        others = np.setdiff1d(np.arange(cfg.n_layers), slots)
        assert not np.asarray(ref[others]).any()           # zeros elsewhere


def test_session_caches_match_reference(run):
    jab, ab_ = run["jabsorbed"], run["absorbed"]
    assert sorted(jab) == sorted(ab_)
    for key in jab:
        if isinstance(jab[key], dict):
            assert sorted(jab[key]) == sorted(ab.HCKDecodeState.FIELDS)
            for f in jab[key]:
                _close(ab_[key][f], jab[key][f])
        else:
            _close(ab_[key], jab[key])


def test_decode_logits_match_reference(run):
    for got, want in zip(run["steps"], run["jsteps"]):
        _close(got, want)


def test_greedy_session_tokens_match_reference(run):
    cfg, pcfg = run["cfg"], run["pcfg"]
    toks = run["toks"]
    jsess = JServeSession(cfg, run["jparams"], max_seq=MAX_SEQ)
    jlast = jsess.prefill({"tokens": jnp.asarray(toks)})
    jout = jsess.decode(jnp.argmax(jlast, -1)[:, None], steps=STEPS)
    sess = ServeSession(pcfg, run["params"], max_seq=MAX_SEQ)
    last = sess.prefill({"tokens": torch.from_numpy(toks.astype(np.int64))})
    out = sess.decode(torch.argmax(last, -1)[:, None], steps=STEPS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert sess.pos == jsess.pos == SEQ + STEPS
    gen = torch.Generator().manual_seed(1)
    sampled = sess.decode(out[:, -1:], steps=2, temperature=0.7,
                          generator=gen)
    assert sampled.shape == (B, 3)
    assert ((sampled >= 0) & (sampled < pcfg.vocab)).all()


# ---------------------------------------------------------------------------
# Configs, parameters, model zoo and entry points
# ---------------------------------------------------------------------------

def test_full_width_config_and_parameters():
    cfg = get_arch("zamba2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_arch("zamba2-7b"))
    assert cfg.param_count() == jget_arch("zamba2-7b").param_count()
    assert get_shape("prefill_32k").seq_len == 32768
    count = sum(int(np.prod(pd.shape)) for _, pd in tf._walk(
        tf.param_defs(cfg)))
    assert 6.7e9 < count < 6.8e9                           # ~13.5 GB in bf16
    jdefs = jax.tree.map(lambda p: p.shape, jtf.param_defs(cfg),
                         is_leaf=lambda p: isinstance(p, jtf.PDef))
    pdefs = jax.tree.map(lambda p: p.shape, tf.param_defs(cfg),
                         is_leaf=lambda p: isinstance(p, tf.PDef))
    assert pdefs == jdefs
    # the decode caches at full width, on the meta device (no memory)
    spec = input_specs(cfg, dataclasses.replace(get_shape("decode_32k"),
                                                global_batch=4),
                       abstract=True)
    assert spec["caches"]["ssm"].shape == (81, 4, 112, 64, 64)
    assert spec["caches"]["shared_hck"]["summary"].shape == (14, 4, 32, 64, 113)


def test_init_params_and_input_specs_on_cpu():
    cfg = get_arch("zamba2-7b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, gen)
    shapes = jax.tree.map(lambda p: p.shape, tf.param_defs(cfg),
                          is_leaf=lambda p: isinstance(p, tf.PDef))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert params["blocks"]["mamba_in_proj"].dtype == torch.float32
    batch = input_specs(cfg, get_shape("prefill_32k").reduced(),
                        generator=gen)
    assert batch["tokens"].shape == (2, 64)
    logits, caches = make_prefill_step(cfg)(params, batch)
    assert logits.shape == (2, 64, cfg.vocab)
    dec = input_specs(cfg, get_shape("decode_32k").reduced(), generator=gen)
    assert dec["pos"] == 32 and dec["tokens"].shape == (2, 1)


def test_unported_parts_raise(monkeypatch):
    cfg = get_arch("zamba2-7b").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 16), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="A16b"):
        tf.forward(params, cfg, {"tokens": toks}, mode="train")
    with pytest.raises(NotImplementedError, match="A16b"):
        tf.param_defs(dataclasses.replace(cfg, family="dense"))
    with pytest.raises(NotImplementedError, match="A16b"):
        tf.moe_block(None, {}, cfg)
    with pytest.raises(KeyError, match="granite-3-2b"):
        get_arch("granite-3-2b")
    # --task krr is ported (A12); without a card and without --device it
    # raises rather than fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch_serve.main(["--task", "krr"])


def test_launcher_runs_on_cpu(capsys):
    out = launch_serve.main(["--task", "lm", "--arch", "zamba2-7b",
                             "--reduced", "--device", "cpu", "--prompt-len",
                             "32", "--gen", "3", "--batch", "2"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "arch=zamba2-7b device=cpu prefill 32 tok" in text
    assert "ms/tok" in text


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch_serve.main(["--task", "lm", "--arch", "zamba2-7b",
                           "--reduced"])
    with pytest.raises(RuntimeError, match="is_available"):
        lm_params_from_arrays({}, cfg=get_arch("zamba2-7b").reduced())
