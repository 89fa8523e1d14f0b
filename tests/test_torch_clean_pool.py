"""The port's CleanSidePool (metrics/clean_pool.py) and its LRU against the
JAX package's on the same sequence of chunks, its guarantees for mutable
tensors, and `score_corpus` through the pool against the uncached path on
the CPU at float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nelegan_tpu.metrics.clean_pool import CleanSidePool as JaxPool
from nelegan_tpu.utils.lru import LRUCache as JaxLRU
from nelegan_tpu_torch import metrics
from nelegan_tpu_torch.metrics.clean_pool import CleanSidePool, tree_map
from nelegan_tpu_torch.parallel import launch
from nelegan_tpu_torch.utils.lru import LRUCache


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _values(keys, lib):
    """A stacked tree for a chunk: a tuple of a [B, 3] float array and a
    dict holding a [B] int array, each row a function of its key."""
    base = np.array([[float(sum(map(ord, k)))] for k in keys])
    vals = (base * np.ones((1, 3)), {"i": base[:, 0].astype(np.int32)})
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return (conv(vals[0]), {"i": conv(vals[1]["i"])})


def _leaves(v):
    return [np.asarray(v[0]), np.asarray(v[1]["i"])]


def test_pool_decisions_match_jax():
    """The same chunks through both pools: the same values back, the same
    rows, LRU evictions, growth, hits, misses and resident bytes, under a
    row cap (4 rows a shape) and, for a second shape, a byte budget that
    leaves it 2 rows."""
    row_bytes = 3 * 8 + 4
    ours = CleanSidePool(max_rows_per_shape=4, max_bytes=6 * row_bytes)
    ref = JaxPool(max_rows_per_shape=4, max_bytes=6 * row_bytes)
    chunks = [("a", ["u0", "u1"]), ("a", ["u2", "u0"]), ("a", ["u3", "u4"]),
              ("a", ["u0", "u1"]), ("a", ["u4", "u3"]), ("b", ["v0", "v1"]),
              ("b", ["v2", "v3"]), ("b", ["v6", "v0"]),
              ("a", ["u5", "u5"]), ("b", ["v6"])]
    for sig, keys in chunks:
        got = ours.ensure(sig, keys, lambda: _values(keys, "torch"))
        want = ref.ensure(sig, keys, lambda: _values(keys, "jax"))
        for g, w in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g, w)
        assert ours._shapes[sig]["map"] == ref._shapes[sig]["map"], sig
        assert ours._shapes[sig]["cap"] == ref._shapes[sig]["cap"]
        assert (ours.hits, ours.misses, ours.resident_bytes, len(ours)) == (
            ref.hits, ref.misses, ref.resident_bytes, len(ref))
    assert ours.hits == 2 and ours.misses == 8
    assert ours._shapes["b"]["cap"] == 2
    assert ours.resident_bytes == 6 * row_bytes
    ours.clear()
    assert len(ours) == 0 and ours.resident_bytes == 0


def test_lru_matches_jax():
    ours, ref = LRUCache(3), JaxLRU(3)
    for op in ["a", "b", "c", "?a", "d", "?b", "e", "?c", "?a"]:
        for c in (ours, ref):
            if op.startswith("?"):
                c.get(op[1:])
            else:
                c[op] = op * 2
        assert list(ours._d.items()) == list(ref._d.items())
    assert ("a" in ours, len(ours), ours["a"]) == (True, 3, "aa")
    with pytest.raises(KeyError):
        ours["b"]


def test_pool_row_cap_lifts_for_pinned_chunks():
    """tests/test_metrics_bucketed.py's case: one chunk pins 10 rows of a
    4-row cap, and a second chunk's rows, with the first pinned, evict
    none of them."""
    pool = CleanSidePool(max_rows_per_shape=4)
    keys = [f"u{i}" for i in range(10)]
    pl, rows = pool.ensure_rows(
        "sig", keys, lambda: torch.arange(10.0)[:, None] * torch.ones(10, 3))
    assert len(set(rows)) == 10
    got = pool.gather_rows("sig", rows)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.arange(10.0))
    _, rows2 = pool.ensure_rows(
        "sig", ["v0", "v1", "v2"],
        lambda: 100.0 + torch.arange(3.0)[:, None] * torch.ones(3, 3),
        pinned_rows=set(rows))
    assert not set(rows2) & set(rows)
    np.testing.assert_array_equal(pool.gather_rows("sig", rows)[:, 0].numpy(),
                                  np.arange(10.0))


def test_pool_tensors_are_not_shared():
    """What a caller got stays as it was: a hit is a copy, growth leaves the
    old pool tensor as it was, and an insert writes only new rows."""
    pool = CleanSidePool(max_rows_per_shape=64)
    first = pool.ensure("s", ["a", "b"], lambda: torch.tensor([[1.0], [2.0]]))
    old, rows = pool.ensure_rows("s", ["a", "b"], lambda: None)
    hit = pool.ensure("s", ["b", "a"], lambda: None)
    assert hit.tolist() == [[2.0], [1.0]]
    hit += 10.0
    assert pool.gather_rows("s", rows).tolist() == [[1.0], [2.0]]
    pool.ensure("s", ["c", "d", "e"],
                lambda: torch.tensor([[3.0], [4.0], [5.0]]))
    new, _ = pool.ensure_rows("s", ["a"], lambda: None)
    assert new is not old and old.shape[0] == 2 and new.shape[0] == 8
    assert old.tolist() == [[1.0], [2.0]] and first.tolist() == [[1.0],
                                                                 [2.0]]
    assert tree_map(lambda x: x + 1, {"k": (torch.zeros(1),)})["k"][0] == 1
    # over an in-process world of one rank, the same calls give the same
    # values and layouts bit for bit, and the same hits and misses
    # (tests/test_torch_parallel.py holds a world of two)
    calls = [("ensure", "s", ["a", "b"], [[1.0], [2.0]]),
             ("ensure", "s", ["b", "a"], None),
             ("ensure_rows", "s", ["c", "a"], [[3.0], [1.0]]),
             ("ensure", "t", ["x"], [[5.0, 6.0]])]

    def play(pool, mesh):
        out = []
        for how, sig, keys, vals in calls:
            def compute(vals=vals):
                # column-major rows, as SIIB's KLT basis comes from eigh
                return torch.tensor(vals, dtype=torch.float64).t().contiguous(
                ).t()
            if how == "ensure":
                out.append(pool.ensure(sig, keys, compute, mesh))
            else:
                _, rows = pool.ensure_rows(sig, keys, compute, None, mesh)
                out.append(pool.gather_rows(sig, rows))
        return out, (pool.hits, pool.misses)

    want, counts = play(CleanSidePool(max_rows_per_shape=64), None)
    with launch.world_of_one("gloo", "cpu") as mesh:
        got, got_counts = play(CleanSidePool(max_rows_per_shape=64), mesh)
    assert got_counts == counts == (1, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.stride() == w.stride()


def _pcm16(x):
    return np.round(np.clip(x, -1, 1) * 32768.0).clip(-32768, 32767) / 32768.0


@pytest.fixture(scope="module")
def corpus(goldens):
    """Three PCM16-exact triples of one 8192-sample bucket, float64."""
    g = goldens("features")
    c, z = g["clean"].astype(np.float64), g["noise"].astype(np.float64)
    rng = np.random.RandomState(4)
    out = []
    for k, m in enumerate((8000, 6500, 5001)):
        o = 3000 * k
        cl = c[o:o + m]
        out.append(tuple(_pcm16(x) for x in (
            cl, 0.5 * z[o + 500:o + 500 + m], cl * rng.uniform(0.6, 1.4))))
    return [list(x) for x in zip(*out)]


def test_score_corpus_through_the_pool_equals_uncached(corpus):
    """All five metrics, chunks of 2 in an 8192-sample bucket: the pool cold,
    then warm on reshuffled chunks (every clean-side half, raw clean and
    noise row a hit), then the PCM16 enhanced rows through enhanced_keys,
    cold and warm, each equal to the uncached scores bit for bit; without
    pool_raw_signals the same."""
    cl, no, en = corpus
    kw = dict(norm=False, vmap_chunk=2, bucket_quant=8192, device="cpu")
    base = metrics.score_corpus(cl, no, en, **kw)
    assert all(set(r) == set(metrics.ALL_METRICS) for r in base)
    assert metrics._pcm16_exact(cl[0]) and not metrics._pcm16_exact(
        cl[0] * 0.77701)
    keys = ["a", "b", "c"]
    pool = CleanSidePool()
    cold = metrics.score_corpus(cl, no, en, clean_cache=pool,
                                clean_keys=keys, **kw)
    assert cold == base and pool.misses == 10 and pool.hits == 0
    assert {s[0] for s in pool._shapes} == {
        "raw-ref", "raw-noz", "estoi-clean", "haspi-clean", "siib-klt"}
    assert len(pool.chunk_cache) == 3                 # the SIIB decisions
    order = [2, 1, 0]
    warm = metrics.score_corpus(*([x[i] for i in order] for x in corpus),
                                clean_cache=pool,
                                clean_keys=[keys[i] for i in order], **kw)
    assert [warm[order.index(i)] for i in range(3)] == base
    assert pool.hits == 10 and pool.misses == 10
    ek = ["ea", "eb", "ec"]
    for _ in range(2):
        got = metrics.score_corpus(cl, no, en, clean_cache=pool,
                                   clean_keys=keys, enhanced_keys=ek, **kw)
        assert got == base
    assert pool._shapes[("raw-enh", 8192)]["pool"].dtype == torch.int16
    assert pool.misses == 12                          # raw-enh, cold only
    bare = metrics.score_corpus(cl, no, en, clean_cache=CleanSidePool(),
                                clean_keys=keys, pool_raw_signals=False,
                                metrics=("estoi", "pesq"), **kw)
    assert bare == [{m: r[m] for m in ("estoi", "pesq")} for r in base]
    with pytest.raises(ValueError, match="clean_keys"):
        metrics.score_corpus(cl, no, en, clean_cache=CleanSidePool(), **kw)
