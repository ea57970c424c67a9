"""The port's llama tier (models/llama, checkpoint, tokenizer) against the
JAX package, case for case with tests/test_llama.py.

The same seeded inputs (JAX-made params carried as numpy, token ids from a
numpy generator) go through both packages on the CPU.  Tolerances:
  * float32 logits: 1e-5, float32 roundoff over a few layers (the reference's
    own golden bound);
  * bf16 logits against JAX's bf16 path: one bf16 step of the largest logit
    (2^-7 of it), because the classifier's output is rounded to bf16 and the
    two libraries may sum its products in another order;
  * bf16 logits against the float64 goldens: the reference's 5e-3;
  * greedy ids and checkpoint bytes: exact.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from eoc_tfhe_tpu.models import checkpoint as jcheckpoint
from eoc_tfhe_tpu.models import llama as jllama
from eoc_tfhe_tpu.models import tokenizer as jtokenizer
from eoc_tfhe_tpu_torch.device import exact_matmuls
from eoc_tfhe_tpu_torch.models import checkpoint, llama, tokenizer

CFG = llama.LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, vocab_size=96, max_seq_len=32)
CONFIGS = {"gqa": CFG, "mha": dataclasses.replace(CFG, n_kv_heads=4),
           "mqa": dataclasses.replace(CFG, n_kv_heads=1)}
_DATA = os.path.join(os.path.dirname(__file__), "data")


def jcfg(cfg):
    """The JAX package's LlamaConfig of the port's."""
    return jllama.LlamaConfig(**dataclasses.asdict(cfg))


def jax_params(cfg, seed=0):
    """The reference's init_params as numpy (the form both packages take)."""
    return {k: np.asarray(v) for k, v in jllama.init_params(jax.random.key(seed),
                                                            jcfg(cfg)).items()}


def both(np_params):
    return ({k: jnp.asarray(v) for k, v in np_params.items()},
            llama.params_from_numpy(np_params, device="cpu"))


def tokens(shape, seed, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def bf16_step(x) -> float:
    return float(np.abs(x).max()) * 2.0 ** -7


@pytest.fixture(scope="module")
def params():
    return jax_params(CFG)


def _np_reference_forward(params, tokens, cfg):
    """Straight-line float64 numpy reference (no cache), as in test_llama.py."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    B, T = tokens.shape
    hd = cfg.head_dim
    cos, sin = llama.rope_tables_np(cfg)

    def rms(x, g):
        return x / np.sqrt((x * x).mean(-1, keepdims=True) + cfg.norm_eps) * g

    def rope(x):
        xr = x.reshape(*x.shape[:-1], -1, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        c, s = cos[None, :T, None], sin[None, :T, None]
        return np.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).reshape(x.shape)

    x = p["tok_embeddings"][tokens]
    for li in range(cfg.n_layers):
        h = rms(x, p["attention_norm"][li])
        q = (h @ p["wq"][li]).reshape(B, T, cfg.n_heads, hd)
        k = (h @ p["wk"][li]).reshape(B, T, cfg.n_kv_heads, hd)
        v = (h @ p["wv"][li]).reshape(B, T, cfg.n_kv_heads, hd)
        q, k = rope(q), rope(k)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = np.repeat(k, rep, 2)
        v = np.repeat(v, rep, 2)
        att = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(hd)
        att = np.where(np.tril(np.ones((T, T), bool)), att, -np.inf)
        w = np.exp(att - att.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        o = np.einsum("bhts,bshd->bthd", w, v).reshape(B, T, cfg.dim)
        x = x + o @ p["wo"][li]
        h = rms(x, p["ffn_norm"][li])
        g = h @ p["w1"][li]
        x = x + ((g / (1 + np.exp(-g))) * (h @ p["w3"][li])) @ p["w2"][li]
    x = rms(x, p["norm"])
    return x @ p.get("output", p["tok_embeddings"]).T


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax_and_numpy_reference(name):
    """float32 forward: the port against JAX at 1e-5 and against the float64
    reference at the reference's 2e-4; grouped-query (gqa, mqa) and
    multi-head attention."""
    cfg = CONFIGS[name]
    jp, tp = both(jax_params(cfg))
    toks = tokens((2, 7), 1)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg(cfg),
                                     compute_dtype=jnp.float32))
    got = llama.forward(tp, torch.from_numpy(toks), cfg, compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 7, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _np_reference_forward(tp, toks, cfg),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_forward_matches_jax(name):
    cfg = CONFIGS[name]
    jp, tp = both(jax_params(cfg, seed=3))
    toks = tokens((2, 9), 2)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg(cfg)))
    got = llama.forward(tp, torch.from_numpy(toks), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=bf16_step(want), rtol=0)


def test_decode_matches_forward(params):
    """Cached single-token decode gives the full forward's logits (float32),
    and each step matches JAX's decode step."""
    jp, tp = both(params)
    B, T = 2, 6
    toks = tokens((B, T), 2)
    full = llama.forward(tp, torch.from_numpy(toks), CFG, compute_dtype=torch.float32)
    cache = llama.init_kv_cache(CFG, B, torch.float32, device="cpu")
    jcache = jllama.init_kv_cache(jcfg(CFG), B, jnp.float32)
    for t in range(T):
        logits, cache = llama.decode_step(tp, cache, t, torch.from_numpy(toks[:, t]), CFG,
                                          compute_dtype=torch.float32)
        jlogits, jcache = jllama.decode_step(jp, jcache, jnp.int32(t), jnp.asarray(toks[:, t]),
                                             jcfg(CFG), compute_dtype=jnp.float32)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=2e-4, rtol=0)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=1e-5, rtol=0)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_generate_greedy_matches_jax(params, compute):
    jp, tp = both(params)
    prompt = tokens((2, 4), 3)
    want = np.asarray(jllama.generate(jp, jnp.asarray(prompt), 5, jcfg(CFG),
                                      compute_dtype=getattr(jnp, compute)))
    outs = [llama.generate(tp, torch.from_numpy(prompt), 5, CFG,
                           compute_dtype=getattr(torch, compute)) for _ in range(2)]
    assert outs[0].shape == (2, 5) and outs[0].dtype == torch.int32
    np.testing.assert_array_equal(outs[0].numpy(), want)
    np.testing.assert_array_equal(outs[1].numpy(), want)


def test_temperature_sampling_by_distribution(params):
    """JAX's categorical sampler cannot be reproduced bit for bit; the port's
    draws follow softmax(logits / temperature) of the reference's logits (a
    chi-square test over 4000 rows of one prompt; the temperature is the
    logits' spread, so that many ids have a fair chance)."""
    jp, tp = both(params)
    rows = 4000
    prompt = np.repeat(tokens((1, 3), 4), rows, axis=0)
    logits = np.asarray(jllama.forward(jp, jnp.asarray(prompt[:1]), jcfg(CFG)))[0, -1]
    logits = logits.astype(np.float64)
    temperature = float(logits.std())
    p = np.exp((logits - logits.max()) / temperature)
    p /= p.sum()
    gen = torch.Generator().manual_seed(7)
    got = llama.generate(tp, torch.from_numpy(prompt), 1, CFG, temperature=temperature,
                         generator=gen)[:, 0].numpy()
    expected = rows * p
    keep = expected >= 5                       # pool the rare ids into one cell
    obs = np.append(np.bincount(got, minlength=CFG.vocab_size)[keep],
                    (~keep[got]).sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    assert keep.sum() >= 3, "temperature leaves too few ids for the test"
    assert stats.chisquare(obs, exp).pvalue > 1e-4
    with pytest.raises(ValueError, match="Generator"):
        llama.generate(tp, torch.from_numpy(prompt[:1]), 1, CFG, temperature=1.0)


def _cfg_small(shared):
    return llama.LlamaConfig(dim=16, hidden_dim=40, n_layers=2, n_heads=2, n_kv_heads=1,
                             vocab_size=48, max_seq_len=16, shared_classifier=shared)


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("shared", [True, False])
def test_checkpoint_roundtrip(tmp_path, version, shared):
    """The port's save equals the reference's byte for byte (from numpy and
    from the port's tensors), loads back exactly, and runs the same."""
    cfg = _cfg_small(shared)
    np_params = jax_params(cfg, seed=4)
    want_path, got_path = tmp_path / "ref.bin", tmp_path / "port.bin"
    jcheckpoint.save_llama2c(str(want_path), np_params, jcfg(cfg), version=version)
    checkpoint.save_llama2c(str(got_path), llama.params_from_numpy(np_params, device="cpu"),
                            cfg, version=version)
    assert got_path.read_bytes() == want_path.read_bytes()
    cfg2, params2 = checkpoint.load_llama2c(str(got_path))
    assert cfg2 == cfg
    for k, v in np_params.items():
        np.testing.assert_array_equal(params2[k], v, err_msg=k)
    toks = tokens((1, 5), 5, cfg.vocab_size)
    a = np.asarray(jllama.forward({k: jnp.asarray(v) for k, v in np_params.items()},
                                  jnp.asarray(toks), jcfg(cfg), compute_dtype=jnp.float32))
    b = llama.forward(llama.params_from_numpy(params2, device="cpu"), torch.from_numpy(toks),
                      cfg, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shared", [True, False])
def test_checkpoint_v2_q80_roundtrip(tmp_path, shared):
    """Q8_0 v2: byte for byte the reference's; loads back within
    quantization error and runs."""
    cfg = dataclasses.replace(_cfg_small(shared), hidden_dim=32)
    np_params = jax_params(cfg, seed=4)
    want_path, got_path = tmp_path / "ref.bin", tmp_path / "port.bin"
    jcheckpoint.save_llama2c(str(want_path), np_params, jcfg(cfg), version=2, group_size=16)
    checkpoint.save_llama2c(str(got_path), np_params, cfg, version=2, group_size=16)
    assert got_path.read_bytes() == want_path.read_bytes()
    cfg2, params2 = checkpoint.load_llama2c(str(got_path))
    _, ref2 = jcheckpoint.load_llama2c(str(want_path))
    assert cfg2 == cfg
    for k, v in np_params.items():
        np.testing.assert_array_equal(params2[k], ref2[k], err_msg=k)
        if k in ("attention_norm", "ffn_norm", "norm"):
            np.testing.assert_array_equal(v, params2[k], err_msg=k)
        else:   # Q8_0: |err| <= scale/2 <= max|w|/254 per group
            np.testing.assert_allclose(params2[k], v, atol=np.abs(v).max() / 127.0, err_msg=k)
    out = llama.forward(llama.params_from_numpy(params2, device="cpu"),
                        torch.from_numpy(tokens((1, 5), 5, cfg.vocab_size)), cfg,
                        compute_dtype=torch.float32)
    assert torch.isfinite(out).all()


def test_quantize_q80_matches_reference_semantics():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 64)).astype(np.float32)
    q, scale, err = checkpoint.quantize_q80(w, 32)
    jq, jscale, jerr = jcheckpoint.quantize_q80(w, 32)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    assert err == jerr
    assert q.dtype == np.int8 and np.abs(q).max() <= 127
    deq = (q.astype(np.float32) * scale[:, None]).reshape(w.shape)
    assert np.abs(deq - w).max() == pytest.approx(err)
    assert err < 0.05


def test_tokenizer_bin_roundtrip(tmp_path):
    tok = tokenizer.byte_tokenizer(300)
    path, ref_path = tmp_path / "tok.bin", tmp_path / "ref.bin"
    tok.save(str(path))
    jtokenizer.byte_tokenizer(300).save(str(ref_path))
    assert path.read_bytes() == ref_path.read_bytes()
    tok2 = tokenizer.Tokenizer.load(str(path))
    assert tok2.tokens == tok.tokens
    assert tok2.scores == pytest.approx(tok.scores)
    s = "Hello TFHE!"
    ids = tok2.encode(s, bos=True)
    assert ids == jtokenizer.Tokenizer.load(str(ref_path)).encode(s, bos=True)
    assert ids[0] == tokenizer.BOS_ID
    assert tok2.decode(ids[1:], bos=True) == s
    assert tok2.decode(ids[1:]) == " " + s


def test_tokenizer_greedy_merges():
    tokens_ = [b"<unk>", b"\n<s>\n", b"\n</s>\n", b"a", b"b", b"ab", b"c"]
    scores = [0.0, 0.0, 0.0, -2.0, -2.0, -1.0, -2.0]
    tok = tokenizer.Tokenizer(tokens_, scores)
    assert tok.encode("abc") == [5, 6] == jtokenizer.Tokenizer(tokens_, scores).encode("abc")
    assert tok.decode([5, 6]) == "abc"


def test_module_holds_the_stacked_params(params):
    """The nn.Module twin of the reference's pytree: every tensor a buffer
    with its shape, and its methods are the plain functions."""
    tp = llama.params_from_numpy(params, device="cpu")
    model = llama.Llama(tp, CFG)
    assert set(dict(model.named_buffers())) == set(params)
    for k, v in params.items():
        assert tuple(model.params[k].shape) == v.shape and model.params[k].dtype == torch.float32
    toks = torch.from_numpy(tokens((1, 5), 6))
    assert torch.equal(model(toks), llama.forward(tp, toks, CFG))
    gen = torch.Generator().manual_seed(1)
    own = llama.init_params(gen, CFG, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in params.items()}
    assert abs(float(own["wq"].std()) - 0.02) < 2e-3 and torch.equal(
        own["norm"], torch.ones(CFG.dim))
    half = llama.params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())


def test_llama_entry_points_default_to_the_card(params, monkeypatch):
    """init_params, params_from_numpy and init_kv_cache run on the card unless
    told otherwise: without one they raise, never fall back; init_params
    refuses a generator on another device than its params'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: llama.init_params(torch.Generator(), CFG),
                 lambda: llama.params_from_numpy(params),
                 lambda: llama.init_kv_cache(CFG, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator is on cpu, params on cuda"):
        llama.init_params(torch.Generator(), CFG)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_product_runs_inside_the_precision_scope(params, dtype, monkeypatch):
    """With the caller's TF32 and reduced-precision bf16 flags on, every
    product of forward, prefill and decode_step (the matmuls and the
    attention einsums) sees both flags off, and the caller's come back."""
    flags = torch.backends.cuda.matmul
    seen = []
    real_matmul, real_einsum = torch.matmul, torch.einsum

    def spy(real):
        def run(*a, **k):
            seen.append((real.__name__, flags.allow_tf32,
                         flags.allow_bf16_reduced_precision_reduction))
            return real(*a, **k)
        return run

    tp = llama.params_from_numpy(params, device="cpu")
    toks = torch.from_numpy(tokens((1, 5), 7))
    old = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
    try:
        monkeypatch.setattr(torch, "matmul", spy(real_matmul))
        monkeypatch.setattr(torch, "einsum", spy(real_einsum))
        llama.forward(tp, toks, CFG, compute_dtype=dtype)
        _, cache = llama.prefill(tp, toks, CFG, compute_dtype=dtype)
        llama.decode_step(tp, cache, 5, toks[:, -1], CFG, compute_dtype=dtype)
        monkeypatch.undo()
        assert flags.allow_tf32 and flags.allow_bf16_reduced_precision_reduction
    finally:
        monkeypatch.undo()
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = old
    names = {name for name, _, _ in seen}
    assert names == {"matmul", "einsum"}, names
    assert len(seen) == 3 * (CFG.n_layers * 9 + 1)
    assert not any(tf32 or red for _, tf32, red in seen)


def test_exact_matmuls_scope_restores_the_flags():
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = True, True
        with exact_matmuls():
            assert not flags.allow_tf32 and not flags.allow_bf16_reduced_precision_reduction
            with exact_matmuls():          # re-entrant
                assert not flags.allow_tf32
        assert flags.allow_tf32 and flags.allow_bf16_reduced_precision_reduction
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = old


def test_hf_conversion_matches_transformers(tmp_path):
    """The reference's HF converter's output runs in the port and matches
    transformers, directly and through the .bin round trip."""
    tfm = pytest.importorskip("transformers")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import convert_model

    hf_cfg = tfm.LlamaConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=96,
        max_position_embeddings=32, rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = tfm.LlamaForCausalLM(hf_cfg)
    model_dir = str(tmp_path / "hf")
    model.save_pretrained(model_dir)

    jcfg_, np_params = convert_model.from_hf(model_dir)
    cfg = llama.LlamaConfig(**dataclasses.asdict(jcfg_))
    toks = torch.tensor([[3, 17, 42, 5, 80]])
    with torch.no_grad():
        want = model(toks).logits.numpy()
    got = llama.forward(llama.params_from_numpy(np_params, device="cpu"), toks, cfg,
                        compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4)

    out = str(tmp_path / "m.bin")
    convert_model.main(["--hf", model_dir, "--out", out])
    cfg2, params2 = checkpoint.load_llama2c(out)
    got2 = llama.forward(llama.params_from_numpy(params2, device="cpu"), toks, cfg2,
                         compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got2, want, atol=3e-4)


# ---------------------------------------------------------------------------
# The checked-in golden fixtures (tests/data/llama_tiny_*), whose logits and
# ids come from the independent float64 oracle tests/llama_oracle.py.
# ---------------------------------------------------------------------------

def _gold():
    return np.load(os.path.join(_DATA, "llama_tiny_golden.npz"))


def _load(version):
    cfg, p = checkpoint.load_llama2c(os.path.join(_DATA, f"llama_tiny_v{version}.bin"))
    return cfg, llama.params_from_numpy(p, device="cpu")


def test_golden_tokenizer_ids():
    tok = tokenizer.Tokenizer.load(os.path.join(_DATA, "llama_tiny_tok.bin"))
    ids = tok.encode("hello world")
    np.testing.assert_array_equal(np.asarray(ids, np.int32), _gold()["token_ids"])
    assert tok.decode(ids) == " hello world"


def test_golden_checkpoint_versions_agree():
    """Every version loads exactly as the reference loads it; v0 and v1 agree
    exactly, v2 within its group-scale error."""
    loaded = {}
    for version in (0, 1, 2):
        path = os.path.join(_DATA, f"llama_tiny_v{version}.bin")
        cfg, p = checkpoint.load_llama2c(path)
        jcfg_, jp = jcheckpoint.load_llama2c(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
        for k in jp:
            np.testing.assert_array_equal(p[k], jp[k], err_msg=f"v{version} {k}")
        loaded[version] = (cfg, p)
    (c0, p0), (_, p1), (c2, p2) = loaded[0], loaded[1], loaded[2]
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
        np.testing.assert_allclose(p2[k], p0[k], atol=2e-2, rtol=0)
    assert (c0.dim, c0.vocab_size) == (32, 280) == (c2.dim, c2.vocab_size)


@pytest.mark.parametrize("version", [0, 1, 2])
def test_golden_saves_are_the_fixture_bytes(tmp_path, version):
    """The fixtures were written by the reference's save_llama2c; the port's
    save of the same weights gives the same bytes."""
    _, p = checkpoint.load_llama2c(os.path.join(_DATA, "llama_tiny_v0.bin"))
    cfg = llama.LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            vocab_size=280, max_seq_len=32)
    out = tmp_path / "m.bin"
    checkpoint.save_llama2c(str(out), p, cfg, version=version)
    with open(os.path.join(_DATA, f"llama_tiny_v{version}.bin"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_golden_forward_logits_and_generate():
    """float32 within 1e-5 of the oracle's goldens, bf16 within the
    reference's 5e-3 and equal to JAX's bf16 logits, greedy ids exactly."""
    gold = _gold()
    cfg, p = _load(0)
    prompt = torch.from_numpy(gold["token_ids"][None].astype(np.int32))
    logits32 = llama.forward(p, prompt, cfg, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(logits32, gold["logits"], atol=1e-5, rtol=0)
    logits_bf = llama.forward(p, prompt, cfg).numpy()
    np.testing.assert_allclose(logits_bf, gold["logits"], atol=5e-3, rtol=0)
    jcfg_, jp = jcheckpoint.load_llama2c(os.path.join(_DATA, "llama_tiny_v0.bin"))
    jlogits = np.asarray(jllama.forward({k: jnp.asarray(v) for k, v in jp.items()},
                                        jnp.asarray(prompt.numpy()), jcfg_))
    np.testing.assert_allclose(logits_bf, jlogits, atol=bf16_step(jlogits), rtol=0)
    gen = llama.generate(p, prompt, 8, cfg).numpy()
    np.testing.assert_array_equal(gen, gold["generated"])


def test_oracle_is_independent_and_agrees():
    import llama_oracle as orc
    path = os.path.join(_DATA, "llama_tiny_v0.bin")
    cfg_o, w = orc.load_v0(path)
    ids = _gold()["token_ids"].tolist()
    lo = orc.forward(cfg_o, w, ids)
    cfg, p = _load(0)
    lm = llama.forward(p, torch.tensor([ids], dtype=torch.int32), cfg,
                       compute_dtype=torch.float32)[0].numpy()
    assert np.abs(lo - lm).max() < 1e-5


def test_prefill_matches_decode_loop():
    """Single-pass prefill == per-token decode ingestion (as in the
    reference, within 2e-2), both equal to JAX's prefill within one bf16
    step, and both continue into the oracle's greedy ids; a cache made by
    JAX's prefill continues in the port."""
    cfg, p = _load(0)
    gold = _gold()
    ids = gold["token_ids"].astype(np.int32)
    toks = torch.from_numpy(ids[None])

    logits_pf, cache_pf = llama.prefill(p, toks, cfg)
    cache = llama.init_kv_cache(cfg, 1, device="cpu")
    for t, tok in enumerate(ids):
        logits_lp, cache = llama.decode_step(p, cache, t, torch.tensor([tok]), cfg)
    np.testing.assert_allclose(logits_pf.numpy(), logits_lp.numpy(), atol=2e-2)

    jcfg_, jp = jcheckpoint.load_llama2c(os.path.join(_DATA, "llama_tiny_v0.bin"))
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    jlogits, jcache = jllama.prefill(jp, jnp.asarray(ids[None]), jcfg_)
    np.testing.assert_allclose(logits_pf.numpy(), np.asarray(jlogits),
                               atol=bf16_step(jlogits), rtol=0)
    assert cache_pf.shape == jcache.shape and cache_pf.dtype == torch.bfloat16
    jax_cache = torch.from_numpy(np.asarray(jcache, np.float32)).to(torch.bfloat16)

    for logits, c in ((logits_pf, cache_pf), (logits_lp, cache), (logits_pf, jax_cache)):
        got, pos = [], len(ids)
        for _ in range(8):
            tok = int(torch.argmax(logits[0]))
            got.append(tok)
            logits, c = llama.decode_step(p, c, pos, torch.tensor([tok]), cfg)
            pos += 1
        np.testing.assert_array_equal(np.asarray(got, np.int32), gold["generated"][0])


def test_param_specs_cover_params(params):
    """The port's tp plan covers every param and is the reference's, entry for
    entry (its PartitionSpecs as tuples)."""
    specs = llama.llama_param_specs(CFG)
    for k in params:
        assert k in specs, k
    jspecs = jllama.llama_param_specs(jcfg(CFG))
    assert specs.keys() == jspecs.keys()
    for k, spec in specs.items():
        assert spec == tuple(jspecs[k]), k


def test_sharded_forward_tp(params, tmp_path):
    """The float32 forward at tp=2 on two gloo ranks (whole heads per rank,
    one sum after wo and one after w2) within 1e-4 of the port's unsharded
    forward and of JAX's, as tests/test_llama.py holds the reference's."""
    from eoc_tfhe_tpu_torch.parallel import mesh
    from torch_parallel_worker import run_ranks
    toks = tokens((2, 5), seed=6)
    inputs = {f"p_{k}": v for k, v in params.items()}
    inputs.update({f"cfg_{k}": np.array(v) for k, v in dataclasses.asdict(CFG).items()
                   if isinstance(v, int) and not isinstance(v, bool)}, tokens=toks)
    outs = run_ranks("llama", 2, tmp_path, inputs)
    jp, tp_ = both(params)
    want_jax = np.asarray(jllama.forward(jp, jnp.asarray(toks), jcfg(CFG),
                                         compute_dtype=jnp.float32))
    want = llama.forward(tp_, torch.from_numpy(toks), CFG, compute_dtype=torch.float32).numpy()
    last, cache = llama.prefill(tp_, torch.from_numpy(toks), CFG, compute_dtype=torch.float32)
    nxt, _ = llama.decode_step(tp_, cache, toks.shape[1], torch.from_numpy(toks[:, 0]), CFG,
                               compute_dtype=torch.float32)
    for out in outs:
        assert out["local_wq_cols"] == CFG.dim // 2 and not out["imported_jax"]
        np.testing.assert_allclose(out["logits"], want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(out["logits"], want_jax, atol=1e-4, rtol=0)
        # prefill and a decode step at tp=2, the cache holding this rank's kv heads
        assert tuple(out["cache_shape"]) == cache.shape[:4] + (CFG.n_kv_heads // 2,
                                                               CFG.head_dim)
        np.testing.assert_allclose(out["prefill_last"], last.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(out["decode_next"], nxt.numpy(), atol=1e-4, rtol=0)
    rank1 = mesh.Mesh(dp=1, tp=2, rank=1, device=torch.device("cpu"))   # its layout only
    shard = llama.shard_params(tp_, llama.llama_param_specs(CFG), rank1)
    assert torch.equal(shard["wo"], tp_["wo"][:, CFG.dim // 2:])
    assert torch.equal(shard["w1"], tp_["w1"][:, :, CFG.hidden_dim // 2:])
    with pytest.raises(ValueError, match="tp=3 must divide"):
        llama._tp_size(CFG, 3)
