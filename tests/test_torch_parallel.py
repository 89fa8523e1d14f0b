"""Data parallelism over torch.distributed (`nelegan_tpu_torch/parallel/`).

One world of two gloo ranks on the CPU, spawned once for the module
through `parallel/launch.py`, runs each module's data-parallel path: the
mesh's collectives; the dp G and D steps (`d_step`, `d_steps_scan`) at
float64, with a ragged batch, and the same steps tensor-parallel on a
second mesh over the same ranks (model axis 2, `shard_params`);
`score_corpus` over the mesh, cold and warm through a `CleanSidePool`; and
`Trainer(data_parallel=True)`, straight and resumed.  A world of four
ranks takes the steps on a data 2 x model 2 mesh.  The references are
computed here in the parent: the JAX package's single-device steps and
the port's unsharded calls; `shard_params`' placement is held against the
JAX package's `_param_spec` without a world.  A further small world
checks that a rank that raises ends the world with an error.

JAX is imported inside the parent's fixtures only: the ranks import this
module to find their function and do not need it.  Torch runs on one
thread in every process.
"""
import copy
import functools
import glob
import os
import shutil
import sys
import time

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from nelegan_tpu_torch import metrics
from nelegan_tpu_torch.config import Config, ModelConfig, TrainConfig
from nelegan_tpu_torch.metrics.clean_pool import CleanSidePool
from nelegan_tpu_torch.parallel import (Mesh, all_gather_rows,
                                        all_reduce_sum, assert_replicated,
                                        gather_params, launch, make_mesh,
                                        replica_digest, replicate,
                                        shard_batch, shard_params)
from nelegan_tpu_torch.parallel.mesh import local_cuda_device
from nelegan_tpu_torch.train import gan
from nelegan_tpu_torch.train.loop import Trainer, TrainPaths
from nelegan_tpu_torch.utils.lru import LRUCache
from nelegan_tpu_torch.utils.tree import tree_map

WORLD = 2
# the steps: a small config at float64 (hidden 32, 2 blocks, two trunk
# convolutions a discriminator), batch 4 of 8192 samples; the ragged batch
# has 3 valid rows of 4, its last repeating the third, as the loop pads one
SMALL = dict(gen_hidden=32, gen_blocks=2, disc_channels=(4, 8),
             disc_kernels=(1, 3))
STEP_CFG = Config(model=ModelConfig(**SMALL))
FULL, RAGGED = np.ones(4), np.array([1.0, 1.0, 1.0, 0.0])
STEP_RTOL = 1e-9            # the models' float64 bar (COMPONENTS.md)
TP = 2                      # the model axis of the tensor-parallel steps
# the JAX TrainState's fields that the reference package shards over its
# model axis (tools/measure_tp.py); the spectral u and v stay replicated
SHARDED_FIELDS = ("gen_params", "gen_opt", "d_params", "d_opt",
                  "dq_params", "dq_opt")
# score_corpus: five utterances in two buckets, chunks of 2 a rank
SCORE_METRICS = ("estoi", "pesq", "visqol", "haspi")
SCORE_LENS = (12000, 11000, 10000, 9000, 8000)
SCORE_KW = dict(norm=False, metrics=SCORE_METRICS, bucket_quant=4096,
                vmap_chunk=2)
SCORE_ATOL = 1e-12
# the trainer: tests/test_torch_trainer.py's tiny config and bars (the
# port's own single-process Trainer is the reference here)
TRAINER_CFG = Config(
    model=ModelConfig(gen_hidden=16, gen_blocks=2, disc_channels=(4, 8),
                      disc_kernels=(1, 3)),
    train=TrainConfig(batch_size=2, num_sampling=4, num_valid=1,
                      gan_epochs=2))
TRAINER_METRICS = ("estoi", "pesq")
SCORE_BAR, MODEL_BAR, UPDATE_BAR = 5e-6, 1e-4, 3e-3
TRAIN_CUTS = ((0, 17000), (3000, 18500), (7000, 20000), (12000, 19000))
TEST_CUT = (9000, 19500)


def _pcm16(x):
    return np.round(np.clip(x, -1, 1) * 32768.0).clip(-32768,
                                                      32767) / 32768.0


def _tensors(state) -> dict:
    """Every tensor of a TrainState by name (parameters, u and v, Adam
    moments and steps) as float64 numpy, and the step counters."""
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("gen", "d", "dq") for k, v in sd[m].items()}
    for m in ("gen_opt", "d_opt", "dq_opt"):
        for i, st in sd[m]["state"].items():
            for k, v in st.items():
                out[f"{m}.{i}.{k}"] = v
    out = {k: v.detach().double().numpy().copy() for k, v in out.items()}
    out["step_g"], out["step_d"] = state.step_g, state.step_d
    return out


def _raw(state) -> dict:
    """Every tensor of a TrainState by name as (dtype, bytes) and the step
    counters: what `replicate` must leave bit for bit."""
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("gen", "d", "dq") for k, v in sd[m].items()}
    for m in ("gen_opt", "d_opt", "dq_opt"):
        for i, st in sd[m]["state"].items():
            for k, v in st.items():
                out[f"{m}.{i}.{k}"] = v
    out = {k: (str(v.dtype), v.detach().contiguous().reshape(-1)
               .view(torch.uint8).numpy().tobytes()) for k, v in out.items()}
    out["steps"] = (state.step_g, state.step_d)
    return out


def _changed(before: dict, after: dict) -> list:
    return sorted(k for k in before.keys() | after.keys()
                  if before.get(k) != after.get(k))


# ------------------------------------------------------------ the ranks
def _rank_mesh(mesh) -> dict:
    """shard_batch / all_gather_rows round trip (a column-major leaf, an
    int16 leaf, an array), all_reduce_sum, replicate and the digest check;
    a model axis that does not divide the world, and a tensor-parallel
    mesh's rows."""
    r = mesh.rank
    x = torch.arange(24, dtype=torch.float64).reshape(4, 6)
    col = x.t().contiguous().t()                       # column-major
    tree = {"x": x, "col": col, "i16": x.to(torch.int16), "np": x.numpy()}
    mine = shard_batch(mesh, tree)
    back = all_gather_rows(mesh, mine)
    sums = all_reduce_sum(mesh, [torch.full((2,), r + 1.0),
                                 torch.full((3,), 10.0 * r)])
    own = {"w": torch.full((3,), float(r)), "n": r}
    rep = replicate(mesh, own)
    state = gan.init_train_state(STEP_CFG, 5, "cpu")
    drawn = _raw(state)                 # the same draw on both ranks
    if r == 1:
        with torch.no_grad():
            state.gen.fc1.weight.add_(1.0)
        state.step_g = 7
    try:
        assert_replicated(mesh, state)
        diverged = None
    except RuntimeError as e:
        diverged = str(e)
    replicate(mesh, state)
    assert_replicated(mesh, state)
    replicated = _changed(drawn, _raw(state))
    try:
        make_mesh(model_parallel=3, devices=["cpu"] * mesh.world)
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    tp = make_mesh(model_parallel=WORLD, devices=["cpu"] * mesh.world)
    return {"rows": mine["x"], "back": back, "col_strides": (
        back["col"].stride(), col.stride()), "sums": sums, "rep": rep,
        "diverged": diverged, "state_step_g": state.step_g,
        "replicated_vs_draw": replicated, "tensors": len(drawn),
        "digest": replica_digest(state), "indivisible": indivisible,
        "tp_coords": (tp.data_size, tp.data_rank, tp.model_rank),
        "tp_rows": shard_batch(tp, x),
        "tp_back": all_gather_rows(tp, shard_batch(tp, x))}


def _rank_steps(mesh, sd, inputs, model_parallel=1) -> dict:
    """Two G steps (full, ragged), two `d_step`s (full, ragged) and one
    `d_steps_scan` over three groups (full, ragged, skipped), each rank on
    its rows; with a `model_parallel` > 1, on a second mesh of that model
    axis, the state sharded over it.  -> losses, the whole state after the
    G steps and at the end (`gather_params`), the all-reduces made, the
    sharded state's replica check (and that of a copy whose replicated u
    rank 1 changed), and the shape of a sharded weight."""
    if model_parallel > 1:
        mesh = make_mesh(model_parallel=model_parallel,
                         devices=["cpu"] * mesh.world)
    state = gan.init_train_state(STEP_CFG, 0, "cpu", dtype=torch.float64)
    state.load_state_dict(tree_map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        sd))
    replicate(mesh, state)
    shard_params(mesh, state)
    cb, nb, eb, fr, img3, img2, tg, tq = inputs
    losses = []
    for rv in (FULL, RAGGED):
        state, loss = gan.g_step_bands(
            state, *shard_batch(mesh, (cb, nb, fr)), STEP_CFG,
            row_valid=shard_batch(mesh, rv), mesh=mesh)
        losses.append(float(loss))
    after_g = _tensors(gather_params(mesh, state))
    for i, rv in enumerate((FULL, RAGGED)):
        state, ld, lq = gan.d_step(
            state, *shard_batch(mesh, (img3, img2, fr, tg[i], tq[i])),
            STEP_CFG, row_valid=shard_batch(mesh, rv), mesh=mesh)
        losses += [float(ld), float(lq)]
    rows = [shard_batch(mesh, (eb, cb, nb, fr)) for _ in range(3)]
    flat = [np.concatenate([g[k] for g in rows]) for k in range(4)]
    state, lvals = gan.d_steps_scan(
        state, *flat, np.stack([shard_batch(mesh, tg[2 + g])
                                for g in range(3)]),
        np.stack([shard_batch(mesh, tq[2 + g]) for g in range(3)]),
        np.stack([shard_batch(mesh, rv) for rv in (FULL, RAGGED, FULL)]),
        np.array([True, True, False]), STEP_CFG, mesh=mesh)
    losses += lvals.reshape(-1).tolist()
    assert_replicated(mesh, state)
    # a replicated state (Adam moments and counts, u and v, shards) goes
    # through replicate unchanged, bit for bit
    before = _raw(state)
    replicate(mesh, state)
    again = _changed(before, _raw(state))
    bent = copy.deepcopy(state)
    if mesh.rank == 1:
        bent.d.layers[0].weight_u.add_(1.0)
    try:
        assert_replicated(mesh, bent)
        diverged = None
    except RuntimeError as e:
        diverged = str(e)
    return {"losses": losses, "after_g": after_g,
            "final": _tensors(gather_params(mesh, state)),
            "all_reduces": mesh.count("all_reduce:"),
            "tp_collectives": mesh.count("tp:"), "diverged": diverged,
            "replicate_changed": again, "tensors": len(before),
            "d_weight_shape": tuple(state.d.layers[1].weight_orig.shape)}


def _rank_scores(mesh, triple) -> dict:
    """score_corpus over the mesh through a CleanSidePool (cold, warm on
    reshuffled chunks, with enhanced_keys) and through a chunk-keyed
    mapping."""
    cl, no, en = triple
    keys, ek = ["a", "b", "c", "d", "e"], ["ea", "eb", "ec", "ed", "ee"]
    kw = dict(SCORE_KW, device="cpu", mesh=mesh)
    out = {}
    pool = CleanSidePool()
    out["cold"] = metrics.score_corpus(cl, no, en, clean_cache=pool,
                                       clean_keys=keys, enhanced_keys=ek,
                                       **kw)
    cold_counts = (pool.hits, pool.misses)
    order = [3, 1, 4, 0, 2]
    warm = metrics.score_corpus(
        *([x[i] for i in order] for x in triple), clean_cache=pool,
        clean_keys=[keys[i] for i in order],
        enhanced_keys=[ek[i] for i in order], **kw)
    out["warm"] = [warm[order.index(i)] for i in range(5)]
    out["pool_counts"] = (cold_counts, (pool.hits, pool.misses))
    cache = LRUCache(max_entries=64)
    out["mapped"] = metrics.score_corpus(cl, no, en, clean_cache=cache,
                                         clean_keys=keys, **kw)
    # keyed by the whole chunk's rows on every rank
    chunk = (12288,) + tuple(zip(keys[:4], SCORE_LENS[:4]))
    out["mapped_keys"] = [name for name in ("estoi-clean", "haspi-clean")
                          if (name,) + chunk in cache]
    return out


class _DigestTrainer(Trainer):
    """The Trainer with its state's digest taken after every epoch."""

    def run_epoch(self, epoch):
        means = super().run_epoch(epoch)
        self.digests = getattr(self, "digests", []) + [
            replica_digest(self.state)]
        return means


def _paths(corpus, run) -> TrainPaths:
    return TrainPaths(train_clean=f"{corpus}/Train/Clean",
                      train_noise=f"{corpus}/Train/Noise",
                      test_clean=f"{corpus}/Test/Clean",
                      test_noise=f"{corpus}/Test/Noise",
                      train_enhanced=f"{corpus}/Train/MultiEnh",
                      output=f"{run}/output", checkpoints=f"{run}/chkpt",
                      log_file=f"{run}/log.txt")


def _count_pesq_rows(patch=setattr) -> list:
    """From here on, the rows score_corpus hands PESQ, summed into the
    returned list's one element (`patch`: setattr, or a monkeypatch's)."""
    rows, fn = [0], metrics.pesq_proxy_16k

    def counted(ref, *args, **kw):
        rows[0] += ref.shape[0]
        return fn(ref, *args, **kw)
    patch(metrics, "pesq_proxy_16k", counted)
    return rows


def _rank_trainer(mesh, corpus, root) -> dict:
    """Two dp epochs, the caches emptied before epoch 2 (as cold as a
    resumed trainer), and epoch 2 again resumed from a copy of the run's
    epoch-1 checkpoint; -> both runs' states, replay, history, digests
    and the files this rank wrote or created under `root`."""
    written = []

    def audit(event, args):
        if event == "open" and isinstance(args[0], str):
            mode, flags = args[1], args[2]
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR
                                         | os.O_CREAT)))
            if writes and args[0].startswith(root):
                written.append(args[0])
        elif (event in ("os.mkdir", "os.rename", "os.remove",
                        "shutil.rmtree") and isinstance(args[0], str)
              and args[0].startswith(root)):
            written.append(args[0])
    sys.addaudithook(audit)

    pesq_rows = _count_pesq_rows()

    def trainer(run):
        return _DigestTrainer(_paths(corpus, f"{root}/{run}"), TRAINER_CFG,
                              metric_set=TRAINER_METRICS, data_parallel=True,
                              device="cpu")
    t = trainer("dp")
    assert t.mesh is not None and t.mesh.world == WORLD
    t.run(1)
    if mesh.rank == 0:
        shutil.copytree(f"{root}/dp/chkpt", f"{root}/resumed/chkpt",
                        symlinks=True)
        shutil.copy(f"{root}/dp/log.txt", f"{root}/resumed/log.txt")
    mesh.barrier()
    t.clear_caches()
    t.start_epoch = 2
    t.run(2)
    scored_rows = pesq_rows[0]
    r = trainer("resumed")
    r.resume(truncate_log=True)
    r.run(2)

    def summary(x):
        return {"state": _tensors(x.state), "digests": x.digests,
                "replay": [(e.enhanced_path.replace(root, ""), e.name,
                            e.scores) for e in x.replay.entries],
                "history": x.history, "telemetry": x.telemetry,
                "all_reduces": x.mesh.count("all_reduce")}
    return {"dp": summary(t), "resumed": summary(r),
            "written": sorted(set(written)), "pesq_rows": scored_rows}


def _rank_all(mesh, step_args, triple, corpus, root) -> dict:
    out, seconds = {}, {}
    for name, fn, args in (("mesh", _rank_mesh, ()),
                           ("steps", _rank_steps, step_args),
                           ("tp_steps", _rank_steps, step_args + (TP,)),
                           ("scores", _rank_scores, (triple,)),
                           ("trainer", _rank_trainer, (corpus, root))):
        t0 = time.process_time()
        out[name] = fn(mesh, *args)
        seconds[name] = time.process_time() - t0
    out["cpu_s"] = seconds
    return out


def _rank_fails(mesh):
    if mesh.rank == 1:
        raise ValueError("injected rank failure")
    mesh.barrier()          # never met: rank 1 is gone


# ------------------------------------------------------------ the parent
def _index_probe(jcfg):
    """(a JAX TrainState of numpy leaves whose every float element holds
    its own index, its leaves, their treedef, and per leaf its
    (TrainState field, first index, size), None for counters and keys).
    No JAX initialisation is compiled: only its shapes are traced."""
    import jax

    from nelegan_tpu.train import gan as jgan

    shapes = jax.eval_shape(functools.partial(jgan.init_train_state,
                                              cfg=jcfg),
                            jax.random.PRNGKey(0))
    probe, spans, n = [], [], 0
    for field in shapes._fields:
        for leaf in jax.tree.leaves(getattr(shapes, field)):
            size = int(np.prod(leaf.shape))
            if np.issubdtype(leaf.dtype, np.floating):
                probe.append(np.arange(n, n + size, dtype=np.float64)
                             .reshape(leaf.shape))
                spans.append((field, n, size))
                n += size
            else:               # counters and keys: 0 in a fresh state
                probe.append(np.zeros(leaf.shape, leaf.dtype))
                spans.append(None)
    treedef = jax.tree.structure(shapes)
    return jax.tree.unflatten(treedef, probe), probe, treedef, spans


def _jax_state_from_port(state, jcfg):
    """The JAX package's TrainState holding the port's float64 `state`:
    the inverse of `models.convert.train_state_from_jax`, read off by
    converting the index probe."""
    import jax

    from nelegan_tpu_torch.models.convert import train_state_from_jax

    probe_state, probe, treedef, spans = _index_probe(jcfg)
    n = sum(span[2] for span in spans if span is not None)
    where = _tensors(train_state_from_jax(probe_state, STEP_CFG, "cpu"))
    values = _tensors(state)
    flat, seen = np.zeros(n), np.zeros(n, bool)
    for k, idx in where.items():
        if isinstance(idx, np.ndarray) and not k.endswith(".step"):
            # a fresh torch Adam has no moments yet: zeros, as optax's
            flat[idx.astype(np.int64)] = (values[k] if k in values else
                                          0.0 * (k.endswith("exp_avg") or
                                                 k.endswith("exp_avg_sq")))
            seen[idx.astype(np.int64)] = True
    assert seen.all()
    return jax.tree.unflatten(treedef, [
        p if span is None else flat[span[1]:span[1] + span[2]].reshape(
            p.shape) for p, span in zip(probe, spans)])


@pytest.fixture(scope="module")
def step_inputs():
    """(the initial state as a JAX TrainState and a port state dict of
    arrays, the JAX config, bands and images of a batch of 4 x 8192
    samples, targets)."""
    from nelegan_tpu.config import Config as JaxConfig
    from nelegan_tpu.config import ModelConfig as JaxModelConfig
    from nelegan_tpu_torch.pipeline import reflect_pad_batch

    jcfg = JaxConfig(model=JaxModelConfig(**SMALL))
    state = gan.init_train_state(STEP_CFG, 3, "cpu", dtype=torch.float64)
    sd = tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                  state.state_dict())
    js = _jax_state_from_port(state, jcfg)
    rng = np.random.RandomState(0)
    clean, lens = reflect_pad_batch([0.03 * rng.randn(8192)
                                     for _ in range(4)])
    noise, _ = reflect_pad_batch([0.03 * rng.randn(8192) for _ in range(4)])
    enh, _ = reflect_pad_batch([0.02 * rng.randn(8192) for _ in range(4)])
    # the ragged batch's padding row repeats the third, as the loop pads
    for a in (clean, noise, enh):
        a[3] = a[2]
    cb, nb, fr = (t.numpy() for t in gan.featurize_bands(
        clean, noise, lens, STEP_CFG, device="cpu"))
    eb = gan.speech_band(enh, STEP_CFG, device="cpu").numpy()
    cb, nb, eb = (a.astype(np.float64) for a in (cb, nb, eb))
    img3, img2 = (t.numpy() for t in gan.d_images(
        *(torch.from_numpy(a) for a in (eb, nb, cb)), torch.from_numpy(fr)))
    tg = rng.uniform(0.2, 0.9, (5, 4, 3))
    tq = rng.uniform(0.2, 0.9, (5, 4, 2))
    return js, sd, jcfg, (cb, nb, eb, fr, img3, img2, tg, tq)


@pytest.fixture(scope="module")
def score_triple(goldens):
    """Five PCM16-exact float64 triples (not a multiple of the world) in
    two 4096-quantised buckets."""
    g = goldens("features")
    c, z = g["clean"].astype(np.float64), g["noise"].astype(np.float64)
    rng = np.random.RandomState(1)
    out = [[], [], []]
    for i, m in enumerate(SCORE_LENS):
        o = 1500 * i
        out[0].append(_pcm16(c[o:o + m]))
        out[1].append(_pcm16(z[o:o + m]))
        out[2].append(_pcm16(c[o:o + m] + 0.1 * i * z[o:o + m]
                             + 0.01 * rng.randn(m)))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, goldens):
    """tests/test_torch_trainer.py's PCM16 corpus."""
    root = tmp_path_factory.mktemp("dp_corpus")
    g = goldens("features")
    for sub in ("Train/Clean", "Train/Noise", "Train/MultiEnh",
                "Test/Clean", "Test/Noise"):
        (root / sub).mkdir(parents=True)

    def write(path, x):
        wavfile.write(path, 16000, (np.clip(x, -1.0, 1.0 - 2.0 ** -15)
                                    * 32768).astype(np.int16))

    for i, (o, n) in enumerate(TRAIN_CUTS):
        name = f"u{i}#Cafeteria#{i}.wav"
        write(root / "Train/Clean" / name, g["clean"][o:o + n])
        write(root / "Train/Noise" / name, g["noise"][o:o + n])
        write(root / "Train/MultiEnh" / name, 0.5 * g["clean"][o:o + n])
    o, n = TEST_CUT
    write(root / "Test/Clean/t0#Cafeteria#0.wav", g["clean"][o:o + n])
    write(root / "Test/Noise/t0#Cafeteria#0.wav", g["noise"][o:o + n])
    return root


@pytest.fixture(scope="module")
def world(step_inputs, score_triple, corpus, tmp_path_factory):
    """The two ranks' results (one spawned world for the module)."""
    _, sd, _, inputs = step_inputs
    root = str(tmp_path_factory.mktemp("dp_runs"))
    t0 = time.perf_counter()
    out = launch.run(_rank_all, WORLD, "gloo",
                     args=((sd, inputs), score_triple, str(corpus), root),
                     devices=["cpu"] * WORLD, threads=1, timeout=600)
    return out, root, time.perf_counter() - t0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here too: the ranks run beside this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_collectives(world):
    """shard_batch's rows, all_gather_rows back bit for bit (a
    column-major leaf keeps its layout, int16 and arrays too),
    all_reduce_sum, replicate (a tree; a TrainState that diverged on rank
    1, caught by assert_replicated first); a model axis of 3 over two
    ranks raises, and on a model axis of 2 the rows follow the data
    coordinate."""
    ranks = [r["mesh"] for r in world[0]]
    x = np.arange(24, dtype=np.float64).reshape(4, 6)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rows"], x[2 * rank:2 * rank + 2])
        for k in ("x", "col", "i16", "np"):
            np.testing.assert_array_equal(r["back"][k], x)
        assert r["back"]["i16"].dtype == np.int16
        assert r["col_strides"][0] == r["col_strides"][1]
        np.testing.assert_array_equal(r["sums"][0], [3.0, 3.0])
        np.testing.assert_array_equal(r["sums"][1], [10.0] * 3)
        assert r["rep"]["n"] == 0 and not r["rep"]["w"].any()
        assert "differs between the ranks" in r["diverged"]
        assert r["state_step_g"] == 0
        assert "model_parallel=3 does not divide the 2 ranks" in \
            r["indivisible"]
        # model axis 2 over two ranks: one data coordinate, which holds
        # every row on both ranks
        assert r["tp_coords"] == (1, 0, rank)
        np.testing.assert_array_equal(r["tp_rows"], x)
        np.testing.assert_array_equal(r["tp_back"], x)
    np.testing.assert_array_equal(ranks[0]["digest"], ranks[1]["digest"])


def test_replicate_leaves_every_tensor_bit_equal(world):
    """`replicate` over gloo: a fresh state whose copy on rank 1 diverged
    comes back as the seed's draw on both ranks, and a trained state
    (Adam moments and step counts, u and v; sharded at model axis 2)
    comes back unchanged; in a world of this process alone, a full-width
    state comes back unchanged; every tensor compared by its bytes."""
    with launch.world_of_one("gloo", "cpu") as mesh:
        state = gan.init_train_state(Config(), 3, "cpu")
        before = _raw(state)
        replicate(mesh, state)
        assert _changed(before, _raw(state)) == []
    for r in world[0]:
        assert r["mesh"]["replicated_vs_draw"] == []
        assert r["mesh"]["tensors"] > 20
        for run in ("steps", "tp_steps"):
            assert r[run]["replicate_changed"] == []
            assert r[run]["tensors"] > r["mesh"]["tensors"]


@pytest.fixture(scope="module")
def jax_steps(step_inputs):
    """The JAX package's single-device steps that `_rank_steps` takes:
    (losses, the state after the G steps, the final state), the states as
    `_tensors` of their conversion."""
    import jax

    from nelegan_tpu.train import gan as jgan
    from nelegan_tpu_torch.models.convert import train_state_from_jax

    js, _, jcfg, (cb, nb, eb, fr, img3, img2, tg, tq) = step_inputs
    want = []
    for rv in (FULL, RAGGED):
        js, loss = jgan.g_step_bands(js, cb, nb, fr, jcfg, row_valid=rv)
        want.append(float(loss))
    after_g = _tensors(train_state_from_jax(jax.tree.map(np.asarray, js),
                                            STEP_CFG, "cpu"))
    # the JAX package's own images (channels last) of the same bands; its
    # d_steps_scan is d_step_bands group by group, a skipped group no step
    jimg3, jimg2 = (np.asarray(a) for a in jgan.d_images(eb, nb, cb, fr))
    for i, rv in enumerate((FULL, RAGGED, FULL, RAGGED)):
        js, ld, lq = jgan.d_step(js, jimg3, jimg2, fr, tg[i], tq[i], jcfg,
                                 row_valid=rv)
        want += [float(ld), float(lq)]
    want += [0.0, 0.0]
    final = _tensors(train_state_from_jax(jax.tree.map(np.asarray, js),
                                          STEP_CFG, "cpu"))
    return want, after_g, final


def _match_jax(ranks, jax_steps) -> None:
    """Every rank's `_rank_steps` result against the JAX package's steps
    within the float64 bar, losses and every state tensor (parameters, u
    and v, Adam moments), and the ranks bit-equal."""
    want, after_g, final = jax_steps
    np.testing.assert_allclose(ranks[0]["losses"][:6], want[:6],
                               rtol=STEP_RTOL, atol=0)
    # d_steps_scan returns its losses in float32
    np.testing.assert_allclose(ranks[0]["losses"][6:], want[6:],
                               rtol=2 ** -23, atol=0)
    for got, ref in ((ranks[0]["after_g"], after_g),
                     (ranks[0]["final"], final)):
        # a torch Adam that has not stepped holds no moments; optax's zeros
        assert got.keys() <= ref.keys()
        assert not any(np.any(ref[k]) for k in ref.keys() - got.keys())
        for k, v in ref.items():
            if k not in got:
                continue
            if isinstance(v, np.ndarray):
                err = np.abs(got[k] - v).max()
                assert err <= STEP_RTOL * max(np.abs(v).max(), 1e-300), k
            else:
                assert got[k] == v, k
    for other in ranks[1:]:
        for key in ("after_g", "final"):
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(other[key][k], v, err_msg=k)
        assert other["losses"] == ranks[0]["losses"]
    # 2 G steps, 2 d_steps and 2 scanned groups of two heads each: one
    # all-reduce over the data group per optimizer step
    assert all(r["all_reduces"] == 2 + 4 + 4 for r in ranks)
    # a replicated u that one rank changed is caught
    assert all("differs between the ranks" in r["diverged"] for r in ranks)


def test_dp_steps_match_jax_single_device(world, jax_steps):
    """The dp G and D steps over two ranks (a full and a ragged batch;
    `d_step` and `d_steps_scan`) equal the JAX package's single-device
    steps within the float64 bar, losses and every state tensor; the ranks
    hold the same bits; one all-reduce per optimizer step."""
    ranks = [r["steps"] for r in world[0]]
    _match_jax(ranks, jax_steps)
    assert all(r["tp_collectives"] == 0 for r in ranks)
    assert ranks[0]["d_weight_shape"] == (8, 4, 3, 3)
    print("rank CPU seconds by part:", [r["cpu_s"] for r in world[0]])


def test_tp_steps_match_jax_single_device(world, jax_steps):
    """The same steps on a mesh of model axis 2 over the two ranks (data
    axis 1), the state sharded by `shard_params`: gathered, every tensor
    within the float64 bar of the JAX package's single-device steps, the
    losses too; the ranks' gathered states and losses bit-equal; the
    layers exchanged channels over the model group, and each rank held
    half of a sharded weight's rows."""
    ranks = [r["tp_steps"] for r in world[0]]
    _match_jax(ranks, jax_steps)
    assert all(r["tp_collectives"] > 0 for r in ranks)
    assert all(r["d_weight_shape"] == (4, 4, 3, 3) for r in ranks)


@pytest.fixture(scope="module")
def world4(step_inputs):
    """Four ranks on a data 2 x model 2 mesh take `_rank_steps`."""
    _, sd, _, inputs = step_inputs
    t0 = time.perf_counter()
    out = launch.run(_rank_steps, 4, "gloo", args=(sd, inputs, TP),
                     devices=["cpu"] * 4, threads=1, timeout=300)
    return out, time.perf_counter() - t0


def test_dp_tp_steps_match_jax_single_device(world4, jax_steps):
    """dp2 x tp2 over four ranks: each data coordinate's two rows, each
    model coordinate's half of every sharded layer; the gathered state and
    the losses equal the JAX package's single-device steps within the
    float64 bar on every rank, bit-equal across the four."""
    ranks, seconds = world4
    _match_jax(ranks, jax_steps)
    assert all(r["tp_collectives"] > 0 for r in ranks)
    assert all(r["d_weight_shape"] == (4, 4, 3, 3) for r in ranks)
    print(f"four-rank world: {seconds:.1f} s")


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_params_places_as_the_jax_package(mp, step_inputs):
    """`shard_params` on a state converted from the JAX package's keeps on
    each model rank exactly the elements that the JAX package's
    `_param_spec` places there: leaf by leaf, the last (output) axis of a
    params or Adam leaf split over the model axis where it divides and
    exceeds 1, every other leaf (spectral u and v, narrow layers) whole.
    Among them: D_Qua's fc3 (2 outputs) is sharded at tp2 and whole at
    tp4, D's (3) whole; the generator's input conv keeps its 128 input
    channels.  No world: the placement makes no collective."""
    from nelegan_tpu.parallel.mesh import _param_spec
    from nelegan_tpu_torch.models.convert import train_state_from_jax

    _, _, jcfg, _ = step_inputs
    probe_state, probe, _, spans = _index_probe(jcfg)
    port = train_state_from_jax(probe_state, STEP_CFG, "cpu")
    n = sum(span[2] for span in spans if span is not None)
    for j in range(mp):
        mesh = Mesh(rank=j, world=mp, device=torch.device("cpu"),
                    backend="gloo", model_parallel=mp)
        sharded = shard_params(mesh, copy.deepcopy(port))
        held = np.zeros(n, bool)
        for k, v in _tensors(sharded).items():
            if isinstance(v, np.ndarray) and not k.endswith(".step"):
                held[v.astype(np.int64).ravel()] = True
        for leaf, span in zip(probe, spans):
            if span is None:
                continue
            field, first, size = span
            idx = np.arange(first, first + size).reshape(leaf.shape)
            want = np.zeros(leaf.shape, bool)
            spec = (_param_spec(None, leaf, mp) if field in SHARDED_FIELDS
                    else ())
            if len(spec) and spec[-1] == "model":
                c = leaf.shape[-1] // mp
                want[..., j * c:(j + 1) * c] = True
            else:
                want[...] = True
            np.testing.assert_array_equal(held[idx], want,
                                          err_msg=f"{field} {leaf.shape}")
        assert (sharded.dq.fc3.tp is not None) == (mp == 2)
        assert sharded.d.fc3.tp is None
        conv0 = sharded.gen.convolutions[0][0].conv.weight
        assert conv0.shape == (STEP_CFG.model.gen_hidden // mp, 128, 5)


def test_score_corpus_over_the_mesh(world, score_triple):
    """Five utterances over two ranks against the port's unsharded call
    within 1e-12 at float64: through a CleanSidePool cold and warm on
    reshuffled chunks (bit-equal to cold; the same hits and misses on both
    ranks) and through a chunk-keyed mapping; both ranks return the same
    list."""
    want = metrics.score_corpus(*score_triple, device="cpu", **SCORE_KW)
    ranks = [r["scores"] for r in world[0]]
    assert ranks[0] == ranks[1]
    got = ranks[0]
    for form in ("cold", "warm", "mapped"):
        for a, b in zip(got[form], want):
            assert a.keys() == b.keys()
            for m in SCORE_METRICS:
                assert abs(a[m] - b[m]) <= SCORE_ATOL * max(abs(b[m]), 1.0), \
                    (form, m, a[m], b[m])
    assert got["warm"] == got["cold"]
    assert got["mapped_keys"] == ["estoi-clean", "haspi-clean"]
    (h0, m0), (h1, m1) = got["pool_counts"]
    assert h0 == 0 and m0 > 0 and m1 == m0 and h1 == m0


def test_trainer_data_parallel_follows_single_process(world, corpus,
                                                      tmp_path, monkeypatch):
    """Trainer(data_parallel=True) over two ranks against the port's
    single-process Trainer, two epochs from the same seed: the same files
    and replay, PCM16 within 1 LSB, scores and state within
    tests/test_torch_trainer.py's bars; the ranks' states bit-equal after
    every epoch; each rank scored fewer rows than the single run; only
    rank 0 wrote files; a dp run resumed from the
    epoch-1 checkpoint equals the straight one bit for bit."""
    ranks, root, _ = world
    dp = [r["trainer"] for r in ranks]
    single = Trainer(_paths(corpus, tmp_path), TRAINER_CFG,
                     metric_set=TRAINER_METRICS, device="cpu")
    origin = _tensors(single.state)
    pesq_rows = _count_pesq_rows(monkeypatch.setattr)
    single.run(2)
    want = _tensors(single.state)
    # each rank scored its share of the files, not all of them
    assert dp[0]["pesq_rows"] == dp[1]["pesq_rows"] < pesq_rows[0], \
        (dp[0]["pesq_rows"], pesq_rows[0])

    got = dp[0]["dp"]
    for run in ("dp", "resumed"):
        for a, b in zip(dp[0][run]["digests"], dp[1][run]["digests"]):
            np.testing.assert_array_equal(a, b)
    assert len(dp[0]["dp"]["digests"]) == 2
    # the same names sampled, written and replayed
    files = sorted(os.path.relpath(p, f"{root}/dp/output") for p in glob.glob(
        f"{root}/dp/output/**/*.wav", recursive=True))
    sfiles = sorted(os.path.relpath(p, tmp_path / "output") for p in
                    glob.glob(str(tmp_path / "output" / "**" / "*.wav"),
                              recursive=True))
    assert files == sfiles and len(files) == 2 * (1 + 4)
    for f in files:
        a = wavfile.read(f"{root}/dp/output/{f}")[1].astype(np.int32)
        b = wavfile.read(tmp_path / "output" / f)[1].astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
    srep = [(e.enhanced_path.replace(str(tmp_path), ""), e.name, e.scores)
            for e in single.replay.entries]
    assert [(p.replace("/dp/", "/", 1), n) for p, n, _ in got["replay"]] \
        == [r[:2] for r in srep]
    err = max(abs(a - b) / max(abs(b), 1.0) for x, y in zip(
        got["replay"], srep) for a, b in zip(x[2], y[2]))
    assert err < SCORE_BAR, err
    for m, hist in single.history.items():
        for a, b in zip(got["history"][m], hist):
            assert abs(a - b) / max(abs(b), 1.0) < SCORE_BAR, (m, a, b)
    assert (got["state"]["step_g"], got["state"]["step_d"]) == \
        (want["step_g"], want["step_d"])
    for k, v in want.items():
        if not isinstance(v, np.ndarray):
            continue
        assert np.abs(got["state"][k] - v).max() <= \
            MODEL_BAR * max(np.abs(v).max(), 1e-300), k
        if k in origin:         # a model tensor: its update in norm
            moved = np.linalg.norm(v - origin[k])
            assert np.linalg.norm(got["state"][k] - v) <= UPDATE_BAR * moved
    # one all-reduce per optimizer step: G steps, and each D step's
    # intelligibility and quality heads
    assert got["all_reduces"] == want["step_g"] + 2 * want["step_d"]
    # resumed from epoch 1: bit for bit
    res = dp[0]["resumed"]
    for k, v in got["state"].items():
        np.testing.assert_array_equal(res["state"][k], v, err_msg=k)
    assert [(p.replace("/resumed/", "/dp/"), n, s) for p, n, s in
            res["replay"]] == got["replay"]
    assert res["history"] == got["history"]
    with open(f"{root}/dp/log.txt") as f, open(f"{root}/resumed/log.txt") as g:
        assert f.read() == g.read()
    # rank 0 wrote the run's files, rank 1 none
    assert dp[1]["written"] == []
    assert any(p.endswith(".ptstate") for p in dp[0]["written"])
    assert any(p.endswith("log.txt") for p in dp[0]["written"])


def test_a_failing_rank_ends_the_world():
    """A rank that raises ends the world with its error within seconds;
    the other, waiting in a barrier it cannot meet, is killed."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as info:
        launch.run(_rank_fails, 2, "gloo", devices=["cpu", "cpu"],
                   threads=1, timeout=300)
    assert "injected rank failure" in str(info.value)
    assert time.perf_counter() - t0 < 60
    with pytest.raises(ValueError, match="gloo or nccl"):
        launch.run(_rank_fails, 2, "mpi")


def test_local_rank_beyond_the_visible_gpus_raises(monkeypatch):
    """A rank's default card is CUDA device LOCAL_RANK; a LOCAL_RANK past
    the visible GPUs raises rather than share another rank's card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert local_cuda_device() == "cuda:0"
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1, but 1 GPUs"):
        local_cuda_device()
