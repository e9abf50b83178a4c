"""The port's KV-cache row write (`kernels.kv_cache_update`) and the model's
``cache_update="scatter"`` branch against the JAX reference, on numpy-seeded
inputs: the plane layout and the row writes exactly (the Pallas kernel in
interpret mode, its XLA twin and the mask oracle), rows past S dropped as
the reference's ``.at[].set`` drops them, the write in place; the scatter
branch bitwise equal to the mask branch and within 1e-4 (f32 compute) of
the reference model with ``cache_update="scatter"`` on identical weights.
On the CPU the wrappers run the kernel's plain version; the CUDA kernel is
checked by the `cuda`-marked test, on a GPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.kernels import kv_cache_update as ref_kv  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import kv_cache_update as kv  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import merge_prefill_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _both(a, dtype="float32"):
    """The same numpy array as a torch tensor and a jax array."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _np(t):
    return t.float().numpy()


def test_planes_roundtrip_matches_reference():
    kv_np = np.random.default_rng(7).standard_normal(
        (3, 12, 2, 4)).astype(np.float32)
    t, j = _both(kv_np)
    planes = kv.to_planes(t)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(ref_kv.to_planes(j)))
    np.testing.assert_array_equal(kv.from_planes(planes, 2).numpy(), kv_np)


@pytest.mark.parametrize("b,s,kh,dh", [(2, 16, 1, 8), (4, 32, 2, 16),
                                       (3, 17, 5, 4)])
def test_kv_cache_update_matches_reference(b, s, kh, dh):
    """C = 1: the port's entry (in place), its plain version and the mask
    oracle against ``kv_cache_update_pallas``, ``_xla`` and ``_ref``,
    exactly; each plane's position is honoured independently."""
    p = b * kh
    r = np.random.default_rng(b * 100 + s)
    cache_np = r.standard_normal((p, s, dh)).astype(np.float32)
    new_np = r.standard_normal((p, dh)).astype(np.float32)
    pos_np = r.integers(0, s, p).astype(np.int32)
    cache, cache_j = _both(cache_np)
    new, new_j = _both(new_np)
    pos, pos_j = torch.from_numpy(pos_np), jnp.asarray(pos_np)
    want = np.asarray(ref_kv.kv_cache_update_ref(cache_j, new_j, pos_j))
    np.testing.assert_array_equal(
        np.asarray(ref_kv.kv_cache_update_pallas(cache_j, new_j, pos_j)),
        want)
    np.testing.assert_array_equal(
        np.asarray(ref_kv.kv_cache_update_xla(cache_j, new_j, pos_j)), want)
    np.testing.assert_array_equal(
        kv.kv_cache_update_ref(cache, new, pos).numpy(), want)
    np.testing.assert_array_equal(
        kv.kv_cache_update_plain(cache.clone(), new, pos).numpy(), want)
    ptr = cache.data_ptr()
    got = kv.kv_cache_update(cache, new, pos)
    assert got is cache and got.data_ptr() == ptr       # written in place
    np.testing.assert_array_equal(cache.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_kv_cache_write_chunk_matches_reference(dtype, c):
    """C >= 1 rows per plane against the reference's
    ``kv_cache_write_chunk``, exactly; positions run past S, and the rows
    at or past S are dropped (the cache is not touched there)."""
    r = np.random.default_rng(c)
    p, s, dh = 6, 12, 4
    cache_np = r.standard_normal((p, s, dh)).astype(np.float32)
    new_np = r.standard_normal((p, c, dh)).astype(np.float32)
    pos_np = np.array([0, 3, s - c, s - 1, s - 2, s], np.int32)
    cache, cache_j = _both(cache_np, dtype)
    new, new_j = _both(new_np, dtype)
    want = ref_kv.kv_cache_write_chunk(cache_j, new_j, jnp.asarray(pos_np))
    got = kv.kv_cache_write_chunk(cache, new, torch.from_numpy(pos_np))
    assert got is cache
    np.testing.assert_array_equal(_np(cache),
                                  np.asarray(want, np.float32))
    # the last plane writes nothing, the one before at most one row
    np.testing.assert_array_equal(_np(cache[-1]),
                                  _np(_both(cache_np, dtype)[0][-1]))
    # a chunk == C sequential single-row writes (int64 positions too)
    seq = _both(cache_np, dtype)[0]
    for i in range(c):
        kv.kv_cache_update(seq, new[:, i], torch.from_numpy(pos_np).long()
                           + i)
    np.testing.assert_array_equal(_np(seq), _np(cache))


def test_kv_cache_write_rejects_a_copy_or_bad_shapes():
    cache = torch.zeros((4, 8, 6))
    with pytest.raises(ValueError, match="contiguous"):
        kv.kv_cache_write_chunk(cache[:, ::2], torch.zeros((4, 1, 6)),
                                torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        kv.kv_cache_write_chunk(cache, torch.zeros((4, 1, 5)),
                                torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        kv.kv_cache_update(cache, torch.zeros((4, 1, 6)),
                           torch.zeros(4, dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _models(cd):
    """Both packages' olmo smoke bundles on identical weights (f32 or bf16
    compute), for each cache_update mode."""
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"), compute_dtype=cd,
                                  cache_update="scatter")
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype=cd)
    port = {mode: build_model(dataclasses.replace(cfg, cache_update=mode),
                              "cpu") for mode in ("mask", "scatter")}
    return ref_m, params_j, port, params


def _decode(m, params, prompt, new, max_len):
    """Prefill ``prompt``, then one decode step of the tokens ``new``
    (``[B, C]``); returns (logits, cache passed in, cache returned)."""
    with torch.no_grad():
        _, pfc = m.prefill(params, {"tokens": torch.from_numpy(prompt)})
        cache = merge_prefill_cache(m.init_cache(prompt.shape[0], max_len),
                                    pfc)
        clen = torch.full((prompt.shape[0],), prompt.shape[1])
        logits, out = m.decode_step(params, {"tokens": torch.from_numpy(new),
                                             "cache_len": clen}, cache)
    return logits, cache, out


@pytest.mark.parametrize("c", [1, 3])
def test_scatter_branch_bitwise_equals_mask(c):
    """The scatter branch writes the new rows in place and returns the
    same dict (the cache is consumed); logits and cache bitwise equal the
    mask branch's, which leaves its input cache as it was."""
    _, _, port, params = _models("bfloat16")
    rng = np.random.default_rng(c)
    prompt = rng.integers(0, 256, (2, 8))
    new = rng.integers(0, 256, (2, c))
    lm, cache_m, out_m = _decode(port["mask"], params, prompt, new, 12)
    ls, cache_s, out_s = _decode(port["scatter"], params, prompt, new, 12)
    assert out_s is cache_s and out_m is not cache_m
    assert torch.equal(lm, ls)
    for leaf in ("k", "v"):
        assert torch.equal(out_m[leaf], out_s[leaf])
        assert not torch.equal(cache_m[leaf], out_m[leaf])


def test_scatter_branch_matches_reference_model():
    """Decode logits of the port's scatter branch against the reference
    model with ``cache_update="scatter"`` on converted weights, f32
    compute, within 1e-4; a one-token step and a three-token chunk."""
    ref_m, params_j, port, params = _models("float32")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, (2, 8))
    _, cj = jax.jit(ref_m.prefill)(params_j, {"tokens": jnp.asarray(prompt)})
    for c in (1, 3):
        new = rng.integers(0, 256, (2, c))
        want, _ = jax.jit(ref_m.decode_step)(
            params_j, {"tokens": jnp.asarray(new),
                       "cache_len": jnp.full((2,), 8, jnp.int32)},
            ref_merge(ref_m.init_cache(2, 12), cj))
        got, _, _ = _decode(port["scatter"], params, prompt, new, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_cache_update_mode_is_checked():
    _, _, port, params = _models("float32")
    m = build_model(dataclasses.replace(port["mask"].cfg,
                                        cache_update="select"), "cpu")
    with pytest.raises(ValueError, match="cache_update"):
        _decode(m, params, np.zeros((1, 4), np.int64),
                np.zeros((1, 1), np.int64), 8)


@pytest.mark.cuda
def test_cuda_kv_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: bitwise, in
    place, f32 / bf16 / f16 caches, C = 1 and 8, int32 and int64
    positions, rows past S dropped, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel runs only on the card)")
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for c, dh in ((1, 128), (8, 128), (3, 6)):
            p, s = 64, 40
            cache = torch.from_numpy(rng.standard_normal(
                (p, s, dh)).astype(np.float32)).to(dtype).cuda()
            new = torch.from_numpy(rng.standard_normal(
                (p, c, dh)).astype(np.float32)).to(dtype).cuda()
            for pdt in (torch.int32, torch.int64):
                pos = torch.from_numpy(rng.integers(0, s + 4, p)).to(
                    pdt).cuda()
                want = kv.kv_cache_write_chunk_plain(cache.clone(), new, pos)
                got = cache.clone()
                ptr = got.data_ptr()
                before = kv.LAUNCHES["kv_cache_update"]
                kv.kv_cache_write_chunk(got, new, pos)
                torch.cuda.synchronize()
                assert kv.LAUNCHES["kv_cache_update"] == before + 1
                assert got.data_ptr() == ptr
                assert torch.equal(got, want)
