"""The port's chunked prefill attention against the JAX reference's
``blocked_causal_attention``: values and gradients on the same numpy
inputs (f32, 1e-4) over chunkings with G > 1, q_chunk != kv_chunk and
``causal=False``; the kv chunks it computes (counted by the flop counter)
against the reference's visible chunks; the chunk rule of the models'
prefill against the reference's own choice; and the olmo-1b and
zamba2-1.2b smoke prefills at prompt 64 and an olmo-1b ``train_loss``
gradient against the reference's, on converted params."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models import zamba2 as ref_zamba2  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models import transformer, zamba2  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

TOL = 1e-4
B, KH, DH = 2, 2, 16

# (S, q_chunk, kv_chunk, G, causal)
CASES = [
    (32, 16, 16, 1, True),
    (32, 8, 16, 1, True),
    (32, 16, 8, 2, True),
    (48, 16, 16, 4, True),
    (64, 8, 32, 2, True),
    (32, 32, 32, 2, True),
    (32, 8, 16, 2, False),
    (33, 1, 1, 1, True),
]


def _qkv(s, g, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, KH * g, DH)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, KH, DH)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _visible(s, q_chunk, kv_chunk, causal):
    """The reference's visible (q block, kv chunk) pairs: ``ki * kv_chunk
    <= qi * q_chunk + (q_chunk - 1)`` (every pair when not causal)."""
    return sum(1 for qi in range(s // q_chunk) for ki in range(s // kv_chunk)
               if not causal or ki * kv_chunk <= qi * q_chunk + q_chunk - 1)


@pytest.mark.parametrize("s,q_chunk,kv_chunk,g,causal", CASES)
def test_blocked_attention_matches_reference(s, q_chunk, kv_chunk, g,
                                             causal):
    q, k, v = _qkv(s, g)
    want = ref_layers.blocked_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_chunk=q_chunk,
        kv_chunk=kv_chunk, causal=causal)
    got = layers.blocked_causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_chunk=q_chunk,
        kv_chunk=kv_chunk, causal=causal)
    assert got.shape == (B, s, KH * g, DH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s,q_chunk,kv_chunk,g,causal",
                         [c for c in CASES if c[0] != 33])
def test_blocked_attention_computes_the_visible_chunks(s, q_chunk, kv_chunk,
                                                       g, causal):
    """Matmul FLOPs are two products per computed kv chunk, each
    ``2 * B * KH * G * q_chunk * kv_chunk * dh``: the count of computed
    chunks equals the reference's visible count.  (At chunks of 1 the
    einsum is no matmul, so that case is counted by no flop counter.)"""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = (torch.from_numpy(a) for a in _qkv(s, g))
    with FlopCounterMode(display=False) as fc:
        layers.blocked_causal_attention(q, k, v, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk, causal=causal)
    per_chunk = 2 * (2 * B * KH * g * q_chunk * kv_chunk * DH)
    assert fc.get_total_flops() == \
        _visible(s, q_chunk, kv_chunk, causal) * per_chunk


@pytest.mark.parametrize("s,q_chunk,kv_chunk,g,causal",
                         [c for c in CASES if c[0] != 33])
def test_blocked_attention_grads_match_reference(s, q_chunk, kv_chunk, g,
                                                 causal):
    q, k, v = _qkv(s, g, seed=1)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(ref_layers.blocked_causal_attention(
            q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk, causal=causal)
            * jnp.asarray(w))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.blocked_causal_attention(qt, kt, vt, q_chunk=q_chunk,
                                          kv_chunk=kv_chunk, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)


def test_blocked_attention_bf16_inputs_return_bf16():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(32, 2))
    got = layers.blocked_causal_attention(q, k, v, q_chunk=8, kv_chunk=16)
    want = layers.causal_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_blocked_attention_refuses_chunks_that_do_not_divide():
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 1))
    with pytest.raises(ValueError, match="must divide"):
        layers.blocked_causal_attention(q, k, v, q_chunk=12, kv_chunk=16)


# ---------------------------------------------------------------------------
# the chunk rule of the models' prefill
# ---------------------------------------------------------------------------

SEQS = (32, 33, 48, 320, 4096)
CHUNKS = ((16, 16), (512, 1024), (8, 16))


def _spy(calls):
    def fake(q, k, v, *, q_chunk, kv_chunk, **_):
        calls.append((q_chunk, kv_chunk))
        return q
    return fake


def _ref_chunks(arch, cfg_chunks, s, monkeypatch):
    """The chunks the reference's own attention sublayer passes to
    ``blocked_causal_attention`` for a sequence of ``s``."""
    calls = []
    cfg = dataclasses.replace(ref_get_smoke(arch), q_chunk=cfg_chunks[0],
                              kv_chunk=cfg_chunks[1])
    params = jax.eval_shape(lambda r: ref_build_model(cfg).init(r),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    h = jax.ShapeDtypeStruct((1, s, cfg.d_model), jnp.float32)
    pos = jax.ShapeDtypeStruct((1, s), jnp.int32)
    if arch == "olmo-1b":
        monkeypatch.setattr(ref_transformer, "blocked_causal_attention",
                            _spy(calls))
        lp = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:],
                                                         x.dtype),
                          params["blocks"])
        jax.eval_shape(lambda lp, h, pos: ref_transformer._attn(
            cfg, lp, h, pos, None), lp, h, pos)
    else:
        monkeypatch.setattr(ref_zamba2, "blocked_causal_attention",
                            _spy(calls))
        jax.eval_shape(lambda sp, h, pos: ref_zamba2._shared_attn(
            cfg, sp, h, pos, None), params["shared"], h, pos)
    return calls


def _port_chunks(arch, cfg_chunks, s, monkeypatch):
    """The chunks the port's attention sublayer runs at: the blocked form's
    arguments (its one form, a one-chunk sequence included)."""
    calls = []
    monkeypatch.setattr(layers, "blocked_causal_attention", _spy(calls))
    cfg = dataclasses.replace(get_smoke(arch), q_chunk=cfg_chunks[0],
                              kv_chunk=cfg_chunks[1])
    gen = torch.Generator().manual_seed(0)
    mod = transformer if arch == "olmo-1b" else zamba2
    params = mod.init_params(cfg, gen, torch.device("cpu"))
    h = torch.zeros((1, s, cfg.d_model))
    pos = torch.arange(s)[None]
    if arch == "olmo-1b":
        lp = {nm: w[0] for nm, w in params["blocks"].items()}
        transformer._attn(cfg, lp, h, pos)
    else:
        zamba2._shared_attn(cfg, params["shared"], h, pos)
    return calls


@pytest.mark.parametrize("cfg_chunks", CHUNKS)
@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_chunk_rule_matches_reference(arch, cfg_chunks, monkeypatch):
    for s in SEQS:
        want = _ref_chunks(arch, cfg_chunks, s, monkeypatch)
        got = _port_chunks(arch, cfg_chunks, s, monkeypatch)
        assert len(want) == 1 and got == want, (s, got, want)
        assert layers.attention_chunks(s, *cfg_chunks) == want[0]


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_one_chunk_prefill_attention_matches_reference(arch):
    """At a one-chunk length (a serving prompt of 8 tokens, and the smoke
    config's whole chunk) the models' `prefill_attention` equals the
    reference's ``blocked_causal_attention`` at the chunks the reference's
    model picks, on finite inputs with the smoke config's heads, 1e-5."""
    cfg = get_smoke(arch)
    g = cfg.n_heads // cfg.n_kv_heads
    for s in (8, min(cfg.q_chunk, cfg.kv_chunk)):
        qc, kc = layers.attention_chunks(s, cfg.q_chunk, cfg.kv_chunk)
        assert (qc, kc) == (s, s)
        rng = np.random.default_rng(s)
        q = rng.standard_normal((B, s, cfg.n_kv_heads * g, cfg.head_dim)
                                ).astype(np.float32)
        k, v = (rng.standard_normal((B, s, cfg.n_kv_heads, cfg.head_dim)
                                    ).astype(np.float32) for _ in range(2))
        want = ref_layers.blocked_causal_attention(
            *(jnp.asarray(a) for a in (q, k, v)), q_chunk=s, kv_chunk=s)
        got = layers.prefill_attention(*(torch.from_numpy(a)
                                         for a in (q, k, v)),
                                       q_chunk=cfg.q_chunk,
                                       kv_chunk=cfg.kv_chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the models' prefill and training on converted params
# ---------------------------------------------------------------------------

PROMPT = 64


@functools.lru_cache(maxsize=None)
def _ref_prefill(arch):
    cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    bundle = ref_build_model(cfg)
    params = bundle.init(jax.random.key(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    logits, cache = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    return (jax.tree.map(np.asarray, params), tokens, np.asarray(logits),
            jax.tree.map(np.asarray, cache))


def _attention_grid(cfg):
    """(q blocks, kv chunks) of the models' attention at `PROMPT`."""
    qc, kc = layers.attention_chunks(PROMPT, cfg.q_chunk, cfg.kv_chunk)
    return PROMPT // qc, PROMPT // kc


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_smoke_prefill_matches_reference(arch):
    """Prompt 64 runs four q blocks and four kv chunks of 16 per layer."""
    params, tokens, want, want_cache = _ref_prefill(arch)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    assert _attention_grid(cfg) == (4, 4)
    bundle = build_model(cfg, "cpu")
    with torch.no_grad():
        got, cache = bundle.prefill(params_from_numpy(params, "cpu"),
                                    {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(want_cache[key], np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_train_loss_grads_match_reference_at_multi_chunk_length():
    """olmo-1b smoke ``train_loss`` at sequence 64 (four chunks of 16):
    the loss and every gradient at 1e-4, remat on."""
    cfg_r = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                compute_dtype="float32")
    bundle_r = ref_build_model(cfg_r)
    params = bundle_r.init(jax.random.key(0))
    tokens = np.random.default_rng(4).integers(
        0, cfg_r.vocab_size, (2, PROMPT)).astype(np.int32)
    rloss, rgrads = jax.value_and_grad(bundle_r.train_loss)(
        params, {"tokens": jnp.asarray(tokens)})
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype="float32")
    bundle = build_model(cfg, "cpu")
    loss, grads = value_and_grad(
        bundle.train_loss,
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=TOL, atol=TOL)
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, rgrads)))
    got = flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        np.testing.assert_allclose(np.asarray(g, np.float32), want[path],
                                   rtol=TOL, atol=TOL, err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("poison", ["none", "k_nan", "k_inf"])
def test_blocked_attention_on_the_card_equals_the_cpu(poison):
    """The chunked attention on the card against itself on the CPU at f32,
    1e-4, with a poisoned key in the first of four kv chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    q, k, v = _qkv(64, 2, seed=5)
    if poison != "none":
        k[:, 3] = np.nan if poison == "k_nan" else np.inf
    args = [torch.from_numpy(a) for a in (q, k, v)]
    want = layers.blocked_causal_attention(*args, q_chunk=16, kv_chunk=16)
    got = layers.blocked_causal_attention(*(a.cuda() for a in args),
                                          q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
