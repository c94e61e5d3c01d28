"""Head dims above 256 on the serving kernels (B1, B2, B3), and paged head
dims that are not a multiple of 8, against the reference.

On the card B1 runs at widths up to 512 (O's 256-column halves on the
grid), and B2/B3 take any d from 8 to 512 (rows staged zero-padded to
whole 8-column chunks). Here, on the CPU, the same numpy inputs go through
the reference (its Pallas kernels in interpret mode) and the port's plain
paths, at the reference's tolerances:

- ``flash_attention`` at d 260, 320, 512 and d 512 with dv 256, under the
  causal and local_causal schedules and the norm bound, bf16;
- ``paged_attention`` with the fused append, the shared-table call and
  ``PagedKVCache.append`` at d 100, 260 and 512 on every page type;
- a 2-layer model at ``head_dim=512`` (dim 1024, 2 q / 1 kv heads):
  ``forward``, ``prefill``, ``prefill_chunk`` and ``decode_step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged import _assert_cache_equal
from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.models import transformer as jtfm
from tpu_flash.ops import flash as jflash
from tpu_flash.ops import paged as jpaged
from tpu_flash_torch.models import transformer as ttfm
from tpu_flash_torch.ops import flash as tflash
from tpu_flash_torch.ops import paged as tpaged
from tpu_flash_torch.utils.convert import (
    cache_from_reference,
    params_from_tree,
    to_numpy,
    to_torch,
)

torch.set_num_threads(2)

# bf16 kernels against each other: the reference's bf16 gate
# (tests/test_flash.py); lse likewise
TOL_BF16 = 2e-2


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (schedule, radius, bound_max): causal, the band, and the norm bound (the
# reference's B9 mode) on the dense schedule
_FLASH_KINDS = [("causal", 0, False), ("local_causal", 40, False),
                ("dense", 0, True)]


@pytest.mark.parametrize("schedule,radius,bound", _FLASH_KINDS,
                         ids=["causal", "local_causal", "bound"])
@pytest.mark.parametrize("d,dv", [(260, 260), (320, 320), (512, 512),
                                  (512, 256)])
def test_flash_attention_wide_matches_reference(d, dv, schedule, radius,
                                                bound):
    """bf16 ``flash_attention`` at widths above 256, GQA 2/1, n 96 (a
    ragged tile), o and lse within 2e-2."""
    n = 96
    arrays = _arrays(d + dv, (1, 2, n, d), (1, 1, n, d), (1, 1, n, dv))
    kw = dict(schedule=schedule, radius=radius, bound_max=bound,
              return_lse=True)
    jo, jl = jflash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), block_q=128,
        block_kv=128, **kw)
    to, tl = tflash.flash_attention(
        *(to_torch(a, "cpu").bfloat16() for a in arrays), **kw)
    assert to.shape == (1, 2, n, dv)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo, np.float32),
                               atol=TOL_BF16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL_BF16)


def test_flash_wide_widths():
    """The attention kernels' compiled widths reach 512: 260 runs at 512,
    and a dim above 512 raises naming the ROADMAP item (A15c)."""
    assert tflash.kernel_head_dim(260, 100) == 512
    assert tflash.kernel_head_dim(512, 512) == 512
    with pytest.raises(NotImplementedError, match="A15c"):
        tflash.kernel_head_dim(513, 64)
    with pytest.raises(NotImplementedError, match="A15c"):
        tflash.kernel_head_dim(64, 600)


# f32 pages: only the f32 summation order differs; bf16/int8/int4: 2e-2;
# fp8: 3e-2 against the reference's kernel, which decodes e4m3 subnormals
# approximately (tests/test_torch_paged.py)
_B2_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2, "int4": 2e-2,
           "fp8": 3e-2}
_PAGE, _KVH, _G = 16, 2, 2


def _caches(dtype, d, lens, rng):
    """The reference's cache with prompts written to slots 0.., and the
    port's copy of it, bit for bit."""
    cfg = JCacheConfig(num_kv_heads=_KVH, head_dim=d, page_size=_PAGE,
                       total_pages=32, max_seqs=4, max_pages_per_seq=8,
                       dtype=dtype)
    tables = 1 + np.arange(4 * 8).reshape(4, 8) % 31
    jc = JPagedKVCache.create(cfg).assign_pages(jnp.asarray(tables, jnp.int32))
    for s, n in enumerate(lens):
        jc = jc.write_prompt(
            s, jnp.asarray(rng.standard_normal((_KVH, n, d)), jnp.float32),
            jnp.asarray(rng.standard_normal((_KVH, n, d)), jnp.float32))
    return jc, cache_from_reference(jc, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4",
                                   "fp8"])
@pytest.mark.parametrize("d", [100, 260, 512])
def test_paged_wide_matches_reference(d, dtype):
    """At d 100 (not a multiple of 8), 260 and 512: ``PagedKVCache.append``
    (B3), then B2 with the fused append (pages as the reference writes
    them, o and lse within its tolerance), then the shared-table call of
    the chunk prefix (every lane on slot 0 at its own position)."""
    rng = np.random.default_rng(d)
    lens = [37, 20, 5]
    jc, tc = _caches(dtype, d, lens, rng)
    tables = np.asarray(jc.page_tables)
    slots = np.array([0, 1, 2], np.int32)
    k, v = (rng.standard_normal((3, _KVH, d)).astype(np.float32)
            for _ in range(2))
    targets = [tables[s, n // _PAGE] for s, n in enumerate(lens)]
    jc = jc.append(jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v))
    tc.append(torch.as_tensor(slots), torch.as_tensor(k), torch.as_tensor(v))
    # the reference kernel's quantized rows: its jitted scales may sit an
    # ulp off the IEEE divide, a code then a step off (tests/test_torch_paged.py)
    quirky = dtype in ("int8", "int4", "fp8")
    _assert_cache_equal(tc, jc, targets if quirky else None)
    # both go on from the port's pages
    jc = _as_reference(tc, jc)

    lens = [n + 1 for n in lens]
    targets = [tables[s, n // _PAGE] for s, n in enumerate(lens)]
    q = rng.standard_normal((3, _KVH * _G, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((3, _KVH, d)).astype(np.float32)
              for _ in range(2))
    jo, jl, jc = jpaged.paged_attention(
        jnp.asarray(q), jc, jnp.asarray(slots),
        new_kv=(jnp.asarray(kn), jnp.asarray(vn)), return_lse=True)
    to, tl, tc = tpaged.paged_attention(
        torch.as_tensor(q), tc, torch.as_tensor(slots),
        new_kv=(torch.as_tensor(kn), torch.as_tensor(vn)), return_lse=True)
    _assert_cache_equal(tc, jc, targets if quirky else None)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=_B2_TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_B2_TOL[dtype])

    jc = _as_reference(tc, jc)
    lanes = np.zeros(5, np.int32)
    pos = np.array([0, 3, 17, 30, 38], np.int32)
    qs = rng.standard_normal((5, _KVH * _G, d)).astype(np.float32)
    kw = dict(radius=16, return_lse=True, shared_page_table=True)
    jo, jl = jpaged.paged_attention(jnp.asarray(qs), jc, jnp.asarray(lanes),
                                    positions=jnp.asarray(pos), **kw)
    to, tl = tpaged.paged_attention(torch.as_tensor(qs), tc,
                                    torch.as_tensor(lanes),
                                    positions=torch.as_tensor(pos), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=_B2_TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_B2_TOL[dtype])


def _as_reference(tc, jc):
    """The reference's cache with the port's pages, scales and lengths."""
    def arr(t):
        if t is None:
            return None
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.view(torch.uint8).numpy().view(
                jnp.float8_e4m3fn))
        if t.dtype == torch.bfloat16:
            return jnp.asarray(to_numpy(t), jnp.bfloat16)
        # a copy: the port updates its lengths in place
        return jnp.asarray(t.numpy().copy())
    return dataclasses.replace(jc, k_pages=arr(tc.k_pages), v_pages=arr(tc.v_pages),
                               k_scales=arr(tc.k_scales),
                               v_scales=arr(tc.v_scales),
                               lengths=arr(tc.lengths))


# the wide model: head_dim 512, float32 (the logits agree to float32
# summation order, the reference engine tests' 1e-3)
_MCFG = dict(vocab_size=256, dim=1024, num_layers=2, num_q_heads=2,
             num_kv_heads=1, head_dim=512, block_q=128, block_kv=128,
             dtype="float32")
JCFG, TCFG = jtfm.ModelConfig(**_MCFG), ttfm.ModelConfig(**_MCFG)
TOL = 1e-3
# logits downstream of a paged call (the chunk prefix, the decode step):
# that call rounds q to bf16 by contract on both sides, and a float32
# summation-order difference in q can flip one of its d = 512 roundings
# (one bf16 ulp, 2⁻⁸ relative) — twice TOL
TOL_PAGED = 2e-3
_CCFG = dict(num_kv_heads=1, head_dim=512, page_size=16, total_pages=32,
             max_seqs=4, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, b, n):
    return np.random.default_rng(seed).integers(1, 255, (b, n)).astype(np.int32)


def test_wide_model_forward_and_prefill_match_reference(params):
    """``forward`` (2 × 40 tokens) and ``prefill`` (37 tokens): logits,
    and the prefill's K/V, within 1e-3."""
    jp, tp = params
    toks = _tokens(0, 2, 40)
    jl = jax.jit(lambda p, t: jtfm.forward(p, t, JCFG))(jp, jnp.asarray(toks))
    tl = ttfm.forward(tp, torch.as_tensor(toks).long(), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    toks = _tokens(1, 1, 37)
    jl, jkv = jax.jit(lambda p, t: jtfm.prefill(p, t, JCFG))(
        jp, jnp.asarray(toks))
    tl, tkv = ttfm.prefill(tp, torch.as_tensor(toks).long(), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)


def test_wide_model_chunk_and_decode_match_reference(params):
    """A 40-token prompt in chunks of 32 on slot 1 of a float32 cache
    (``prefill_chunk``: the shared-table prefix and B1 on the chunk), then
    three ``decode_step``s: logits within 2e-3 (TOL_PAGED), the greedy
    tokens and the lengths equal, layer 0's pages within 1e-3 (float32
    summation order)."""
    jp, tp = params
    cfg = JCacheConfig(**_CCFG, dtype="float32")
    table = jnp.zeros((4, 8), jnp.int32).at[1].set(jnp.arange(1, 9))
    jcaches = [JPagedKVCache.create(cfg).assign_pages(table)
               for _ in range(2)]
    tcaches = [cache_from_reference(c, device="cpu") for c in jcaches]
    prompt = _tokens(2, 1, 40)[0].tolist()
    chunk_fn = jax.jit(jtfm.prefill_chunk,
                       static_argnames=("cfg", "pages_bound"))
    for off in (0, 32):
        chunk = prompt[off:off + 32]
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(chunk)] = chunk
        pb = max(1, -(-off // 16))
        jl, jg, jcaches = chunk_fn(jp, jnp.asarray(toks), off, len(chunk),
                                   jcaches, 1, cfg=JCFG, pages_bound=pb)
        tl, tg, tcaches = ttfm.prefill_chunk(
            tp, torch.as_tensor(toks).long(), off, len(chunk), tcaches, 1,
            TCFG, pages_bound=pb)
        n = len(chunk)
        np.testing.assert_allclose(tl[0, :n].numpy(), np.asarray(jl)[0, :n],
                                   atol=TOL_PAGED)
        assert int(tg) == int(jg)
    decode_fn = jax.jit(lambda *a: jtfm.decode_step(*a, JCFG, pages_bound=4))
    new, pos, slots = np.array([int(tg)], np.int32), np.array([40], np.int32), \
        np.array([1], np.int32)
    for _ in range(3):
        jl, jcaches = decode_fn(jp, jnp.asarray(new), jnp.asarray(pos),
                                jcaches, jnp.asarray(slots))
        tl, tcaches = ttfm.decode_step(
            tp, torch.tensor(new).long(), torch.tensor(pos), tcaches,
            torch.tensor(slots), TCFG, pages_bound=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL_PAGED)
        for jc, tc in zip(jcaches, tcaches):
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(jc.lengths))
        # layer 0's pages depend on no paged call: float32 order only
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(getattr(tcaches[0], name).numpy(),
                                       np.asarray(getattr(jcaches[0], name)),
                                       atol=TOL)
        new = np.argmax(np.asarray(jl), axis=-1).astype(np.int32).reshape(1)
        pos = pos + 1
