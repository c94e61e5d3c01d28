"""Port parity: sequence-sharded decode (``parallel/ring_decode.py``).

``sharded_paged_attention`` over 2 and 4 virtual sequence ranks of a
CPU mesh (``parallel/mesh.py``) against the reference's under
``shard_map`` on as many of conftest's virtual CPU devices, at
``tests/test_ring_decode.py``'s shapes (2 lanes, 2 kv / 4 q heads, d 32,
page 16, 29 tokens cut unevenly over the shards): float32, int8 and int4
pages, without the append and with it (the new token's K/V on the last
rank only). The shard caches are filled once by the port's append and
handed to the reference bit for bit. Then ``merge_shard_partials`` against
the reference's on partials with empty shards (lse = −inf), and the
merged output against one cache holding the whole history.

Tolerances: o (float32 queries, so a float32 output) against the
reference at 1e-6 on every page type: the partials differ by float32
summation order only (~2e-7 measured); appended pages bit-exact; the merge
alone 1e-6; the whole-history cache 2e-2 (the reference's test: it holds
the sharded history's bf16 q cast and quantized pages against one walk).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_flash.cache.paged_cache import CacheConfig as JCacheConfig
from tpu_flash.cache.paged_cache import PagedKVCache as JPagedKVCache
from tpu_flash.parallel.ring_decode import merge_shard_partials as jmerge
from tpu_flash.parallel.ring_decode import sharded_paged_attention as jsharded
from tpu_flash_torch.cache.paged_cache import CacheConfig, PagedKVCache
from tpu_flash_torch.ops.paged import paged_attention
from tpu_flash_torch.parallel.mesh import make_mesh
from tpu_flash_torch.parallel.ring_decode import (
    merge_shard_partials,
    sharded_paged_attention,
)
from tpu_flash_torch.utils.convert import to_numpy

torch.set_num_threads(2)

_CFG = dict(num_kv_heads=2, head_dim=32, page_size=16, total_pages=32,
            max_seqs=4, max_pages_per_seq=4)
_B, _KH, _QH, _D, _TOTAL = 2, 2, 4, 32, 29
_TOL = 1e-6
_FIELDS = ("k_pages", "v_pages", "k_scales", "v_scales", "page_tables",
           "lengths")


def _jmesh(n):
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _inputs(dtype, shards, seed):
    """Port shard caches (tokens cut as the reference's test cuts them),
    one port cache of the whole history, q and the new token's K/V."""
    rng = np.random.default_rng(seed)
    cfg = CacheConfig(dtype=dtype, **_CFG)
    toks = [tuple(torch.from_numpy(rng.standard_normal(
        (_B, _KH, _D)).astype(np.float32)) for _ in "kv")
        for _ in range(_TOTAL)]
    cuts = np.linspace(0, _TOTAL, shards + 1).astype(int)
    slots = torch.arange(_B, dtype=torch.int32)

    def filled(part):
        c = PagedKVCache.create(cfg, "cpu")
        c.page_tables[:, :3] = torch.arange(1, 13, dtype=torch.int32).reshape(
            4, 3)
        for k, v in part:
            c.append(slots, k, v)
        return c

    caches = [filled(toks[cuts[j]:cuts[j + 1]]) for j in range(shards)]
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((_B, _QH, _D), (_B, _KH, _D), (_B, _KH, _D)))
    return caches, filled(toks), q, kn, vn, cuts


def _to_jax(c):
    base = JPagedKVCache.create(JCacheConfig(**dataclasses.asdict(c.config)))
    return dataclasses.replace(base, **{
        f: None if getattr(c, f) is None else jnp.asarray(
            to_numpy(getattr(c, f))) for f in _FIELDS})


@functools.lru_cache(maxsize=None)
def _jax_fn(dtype, shards):
    """The reference's sharded decode under shard_map: the merged output
    without the append, then with it, and the caches after."""
    mesh = _jmesh(shards)
    quant = dtype != "float32"
    slots = jnp.arange(_B, dtype=jnp.int32)

    def local(q, cache, kn, vn):
        cache = jax.tree_util.tree_map(lambda x: x[0], cache)
        o0 = jsharded(q[0], cache, slots, "seq")
        o1, cache = jsharded(q[0], cache, slots, "seq", new_kv=(kn[0], vn[0]))
        return o0[None], o1[None], jax.tree_util.tree_map(lambda x: x[None],
                                                          cache)

    proto = JPagedKVCache.create(JCacheConfig(dtype=dtype, **_CFG))
    specs = dataclasses.replace(
        proto, k_pages=P("seq"), v_pages=P("seq"),
        k_scales=P("seq") if quant else None,
        v_scales=P("seq") if quant else None,
        page_tables=P("seq"), lengths=P("seq"))
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("seq"), specs, P("seq"), P("seq")),
        out_specs=(P("seq"), P("seq"), specs), check_vma=False))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_sharded_decode_matches_reference(dtype, shards):
    """The merged output without and with the append, the tail rank's
    pages and every rank's length against the reference's; the other
    ranks' pages untouched."""
    caches, _, q, kn, vn, cuts = _inputs(dtype, shards, seed=3)
    jcaches = [_to_jax(c) for c in caches]
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcaches)

    def rep(t):
        return jnp.broadcast_to(jnp.asarray(t.numpy())[None],
                                (shards, *t.shape))

    jo0, jo1, jstack = _jax_fn(dtype, shards)(rep(q), stack, rep(kn), rep(vn))
    axis = make_mesh(seq=shards, devices="cpu").axis("seq")
    slots = torch.arange(_B, dtype=torch.int32)
    before = [c.k_pages.clone() for c in caches]
    o0 = sharded_paged_attention(q, caches, slots, axis)
    o1, _ = sharded_paged_attention(q, caches, slots, axis, new_kv=(kn, vn))
    np.testing.assert_allclose(o0.numpy(), np.asarray(jo0[0]),
                               atol=_TOL)
    np.testing.assert_allclose(o1.numpy(), np.asarray(jo1[0]),
                               atol=_TOL)
    counts = np.diff(cuts)
    for j, c in enumerate(caches):
        tail = j == shards - 1
        assert c.lengths[:_B].tolist() == [int(counts[j]) + tail] * _B
        assert np.asarray(jstack.lengths[j, :_B]).tolist() == \
            c.lengths[:_B].tolist()
        np.testing.assert_array_equal(to_numpy(c.k_pages),
                                      np.asarray(jstack.k_pages[j]))
        np.testing.assert_array_equal(to_numpy(c.v_pages),
                                      np.asarray(jstack.v_pages[j]))
        if not tail:
            assert torch.equal(c.k_pages, before[j])


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_sharded_decode_matches_whole_history(dtype):
    """Four ranks against one cache that holds the whole history (the
    reference's own check): o within 2e-2, the merged lse within 1e-5."""
    caches, full, q, kn, vn, _ = _inputs(dtype, 4, seed=4)
    axis = make_mesh(seq=4, devices="cpu").axis("seq")
    slots = torch.arange(_B, dtype=torch.int32)
    o, lse, _ = sharded_paged_attention(q, caches, slots, axis,
                                        new_kv=(kn, vn), return_lse=True)
    ro, rl, _ = paged_attention(q, full, slots, new_kv=(kn, vn),
                                return_lse=True)
    assert float((o - ro).abs().max()) < 2e-2
    assert float((lse - rl).abs().max()) < 1e-5


@pytest.mark.parametrize("shards", [2, 4])
def test_merge_shard_partials_matches_reference(shards):
    """merge_shard_partials against the reference's under shard_map, with
    one shard empty everywhere and one row empty on every shard (o = 0)."""
    rng = np.random.default_rng(5 + shards)
    o = rng.standard_normal((shards, 3, 4, 8)).astype(np.float32)
    lse = rng.standard_normal((shards, 3, 4)).astype(np.float32)
    lse[1] = -np.inf
    lse[:, 2, 1] = -np.inf
    mesh = _jmesh(shards)
    fn = jax.jit(jax.shard_map(
        lambda o, l: jmerge(o[0], l[0], "seq")[None], mesh=mesh,
        in_specs=(P("seq"), P("seq")), out_specs=P("seq"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(o), jnp.asarray(lse))[0])
    axis = make_mesh(seq=shards, devices="cpu").axis("seq")
    got = merge_shard_partials([torch.from_numpy(x) for x in o],
                               [torch.from_numpy(x) for x in lse], axis)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(got[2, 1].abs().max()) == 0.0
