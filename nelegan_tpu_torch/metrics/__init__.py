"""The five metrics scored on the card: SIIB, HASPI v2, ESTOI, PESQ, ViSQOL.

Counterpart of `nelegan_tpu/metrics/__init__.py`.  `score_pair` scores one
(clean, noise, enhanced) triple, `score_batch` a list of them, and
`score_corpus` a corpus in length buckets, `vmap_chunk` utterances to a
batch, each row with its `n_valid`.  Wrapper semantics follow the
reference's intel.py: the intelligibility metrics (SIIB, HASPI, ESTOI)
compare clean speech with enhanced speech plus noise (the near-end listener
hears both), the quality metrics (PESQ, ViSQOL) clean with enhanced, and
``norm=True`` applies the logistic calibrations (intel.py:102-160) of a
`MetricCalibration`.

`score_corpus` caches clean-side halves in a plain mapping (per chunk
composition) or a `CleanSidePool` (per utterance, with the raw clean and
noise rows and, through `enhanced_keys`, PCM16 enhanced rows), and scores
over a data-parallel `parallel.Mesh`, each rank its rows of every chunk.
What the reference package does only for its remote-device tunnel (timing
probes, power-of-two row padding) changes no score and is not here.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from nelegan_tpu_torch.config import MetricCalibration
from nelegan_tpu_torch.device import resolve_device
from nelegan_tpu_torch.dsp.resample import resample_poly
from nelegan_tpu_torch.metrics.calibrate import (  # noqa: F401
    logistic, make_mappers, make_mappers_np)
from nelegan_tpu_torch.metrics.estoi import (
    estoi, estoi_10k, estoi_clean_10k, estoi_from_clean_10k)
from nelegan_tpu_torch.metrics.haspi import (  # noqa: F401
    haspi_v1, haspi_v1_24k, haspi_v2, haspi_v2_24k, haspi_v2_clean_24k,
    haspi_v2_from_clean_24k, hasqi_v2, hasqi_v2_24k, resample_to_24k)
from nelegan_tpu_torch.metrics.pesq import (  # noqa: F401
    mos_lqo_wb, pesq_p862, pesq_p862_16k)
from nelegan_tpu_torch.metrics.siib import (
    HOP as SIIB_HOP, _vad_mask, siib, siib_gauss_16k, siib_gauss_16k_with_klt,
    siib_klt_16k)
from nelegan_tpu_torch.metrics.visqol import (  # noqa: F401
    visqol_speech, visqol_speech_16k)
from nelegan_tpu_torch.parallel.mesh import all_gather_rows

# The reference package's call-site names for the quality metrics (the
# reference scores them with pypesq and the ViSQOL binary).
pesq_proxy = pesq_p862
pesq_proxy_16k = pesq_p862_16k
visqol_proxy = visqol_speech
visqol_proxy_16k = visqol_speech_16k

ALL_METRICS = ("siib", "haspi", "estoi", "pesq", "visqol")
# the longest tiled SIIB row (~131 s): one mostly silent utterance would
# otherwise size every row of its chunk
MAX_TILED = 2_097_152


def _check_metrics(metrics: Sequence[str]) -> None:
    for m in metrics:
        if m not in ALL_METRICS:
            raise ValueError(f"unknown metric {m}")


def score_pair_async(clean, noise, enhanced, fs: int = 16000,
                     norm: bool = True,
                     metrics: Sequence[str] = ALL_METRICS, device=None,
                     calib: MetricCalibration = MetricCalibration()
                     ) -> Dict[str, Any]:
    """Like `score_pair`, but returns 0-d tensors on the device, not
    fetched.  Signals are host arrays; they are scored in their own dtype
    (float32 at least) on `device` (None: CUDA)."""
    _check_metrics(metrics)
    dev = resolve_device(device)
    n = min(len(clean), len(enhanced), len(noise))
    clean = np.asarray(clean)[:n]
    enh = np.asarray(enhanced)[:n]
    noisy_enh = enh + np.asarray(noise)[:n]
    mappers = make_mappers(calib)

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    out: Dict[str, Any] = {}
    for m in metrics:
        if m == "siib":
            raw = siib(clean, noisy_enh, fs, device=dev)
        elif m == "haspi":
            raw = haspi_v2(on_dev(clean), fs, on_dev(noisy_enh), fs)[0]
        elif m == "estoi":
            raw = estoi(on_dev(clean), on_dev(noisy_enh), fs)
        elif m == "pesq":
            raw = pesq_proxy(on_dev(clean), on_dev(enh), fs)
        else:
            raw = visqol_proxy(on_dev(clean), on_dev(enh), fs)
        out[m] = mappers[m](raw) if norm else raw
    return out


def score_pair(clean, noise, enhanced, fs: int = 16000, norm: bool = True,
               metrics: Sequence[str] = ALL_METRICS, device=None,
               calib: MetricCalibration = MetricCalibration()
               ) -> Dict[str, float]:
    """The requested metrics of one utterance triple (reference read_STOI,
    read_SIIB, read_HASPI, read_PESQ, audio_util.py:120-228): trimmed to the
    shortest signal, the intelligibility metrics hear enhanced + noise, the
    quality metrics enhanced alone."""
    return {k: float(v) for k, v in score_pair_async(
        clean, noise, enhanced, fs, norm, metrics, device, calib).items()}


def score_batch(clean_list, noise_list, enhanced_list, fs: int = 16000,
                norm: bool = True, metrics: Sequence[str] = ALL_METRICS,
                device=None, calib: MetricCalibration = MetricCalibration()):
    """Score a list of triples: every metric is launched for every triple,
    and the scores come to the host in one copy at the end."""
    pending = [score_pair_async(c, n, e, fs, norm, metrics, device, calib)
               for c, n, e in zip(clean_list, noise_list, enhanced_list)]
    if not pending:
        return []
    keys = list(pending[0])
    vals = torch.stack([torch.stack([p[k].to(torch.float64) for k in keys])
                        for p in pending]).cpu().numpy()
    return [{k: float(vals[i, j]) for j, k in enumerate(keys)}
            for i in range(len(pending))]


def _nv10(nv: torch.Tensor) -> torch.Tensor:
    return -(-nv * 5 // 8)


def _nv24(nv: torch.Tensor) -> torch.Tensor:
    return -(-nv * 3 // 2)


def _tile(sig: torch.Tensor, nv: torch.Tensor, sv: torch.Tensor, sb: int
          ) -> torch.Tensor:
    """Each row's valid prefix repeated to `sv` samples, zeros to `sb`."""
    pos = torch.arange(sb, device=sig.device)
    idx = pos[None, :] % torch.clamp_min(nv, 1)[:, None]
    return torch.gather(sig, 1, idx) * (pos[None, :] < sv[:, None]).to(
        sig.dtype)


def siib_tiled_length(clean: np.ndarray, fs: int = 16000) -> int:
    """The length SIIB scores an utterance of `clean` at: the tile-to-20-s
    rule's factor times its length, capped at MAX_TILED."""
    n = len(clean)
    active = _vad_mask(clean).sum() / (fs / SIIB_HOP)
    m_fac = (max(int(np.floor(25.0 / max(active, 0.25))), 1)
             if active < 20 else 1)
    return min(m_fac, max(MAX_TILED // max(n, 1), 1)) * n


def score_corpus(clean_list, noise_list, enhanced_list, fs: int = 16000,
                 norm: bool = True, metrics: Sequence[str] = ALL_METRICS,
                 bucket_quant: int = 16384, vmap_chunk: int = 8, mesh=None,
                 clean_cache=None, clean_keys: Sequence = None,
                 pool_raw_signals: bool = True,
                 enhanced_keys: Sequence = None, device=None,
                 calib: MetricCalibration = MetricCalibration()):
    """Bucketed corpus scoring.

    Utterances are zero-padded to the next multiple of `bucket_quant` and
    scored `vmap_chunk` rows at a time as one batch per metric, each row
    with its `n_valid`, so a padded row scores as its trimmed signal.  SIIB
    tiles each row on the device to its tiled length (the tile-to-20-s
    rule, decided on the host) inside a buffer of the chunk's tiled bucket.
    When every signal round-trips PCM16 exactly (16-bit wav files), the
    rows go to the device as int16 and are decoded there, to the same
    values.

    `clean_cache` with `clean_keys` (one hashable key per utterance, naming
    its (clean, noise) pair) keeps the clean-side halves of ESTOI, HASPI v2
    and SIIB (its KLT basis) across calls, on the device, in one of two
    forms:
      * a plain mapping (e.g. `utils.lru.LRUCache`), per chunk composition:
        ``(name, blen) + ((clean_key, n_valid), ...)``, and the SIIB tiling
        decision as ``("siib-vad", clean_key, n_valid)``;
      * a `metrics.clean_pool.CleanSidePool`, per utterance, so that hits
        survive reshuffled chunks.  With `pool_raw_signals` the pool also
        keeps the raw clean and noise rows ("raw-ref", "raw-noz"), so that
        a repeated call uploads only the enhanced rows; with
        `enhanced_keys` (one key per utterance naming the enhanced signal's
        content, e.g. its file) and PCM16 signals it keeps the enhanced
        rows too ("raw-enh", int16), masked to `n_valid` on the device.  The
        SIIB tiling decisions go to its `chunk_cache`.

    With a `mesh` (`parallel.make_mesh`) every rank passes the whole
    corpus, as the reference package's mesh path takes it: a chunk is
    `vmap_chunk * world` utterances wide (world: the data axis's size),
    padded to a multiple of the world by repeating its last row, and each
    rank scores its data coordinate's rows of it (the pool's or the
    mapping's entries too; a mapping keys the rank's values by the whole
    chunk).  The scores are all-gathered in one collective, so every rank
    returns the whole list in input order.
    """
    _check_metrics(metrics)
    pool = clean_cache if hasattr(clean_cache, "ensure") else None
    if pool is not None and clean_keys is None:
        raise ValueError("a CleanSidePool clean_cache needs clean_keys")
    assert fs == 16000
    dev = (mesh.device if mesh is not None and device is None
           else resolve_device(device))
    world = 1 if mesh is None else mesh.data_size
    n_utts = len(clean_list)
    lens = [min(len(c), len(n), len(e)) for c, n, e in
            zip(clean_list, noise_list, enhanced_list)]
    dtype = np.result_type(np.float32, *(np.asarray(s).dtype for lst in
                                         (clean_list, noise_list,
                                          enhanced_list) for s in lst))
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    results = [dict() for _ in range(n_utts)]
    mappers = make_mappers_np(calib)
    # one decision for the whole call: int16 rows only when every signal
    # is a PCM16 round trip
    pcm16_ok = all(_pcm16_exact(s[:m]) for lst in
                   (clean_list, noise_list, enhanced_list)
                   for s, m in zip(lst, lens))
    # the mapping that holds host-side values (the SIIB tiling decision)
    host_cache = pool.chunk_cache if pool is not None else clean_cache

    width = vmap_chunk * world
    buckets: Dict[int, list] = {}
    for i, ln in enumerate(lens):
        buckets.setdefault(-(-ln // bucket_quant) * bucket_quant, []).append(i)
    chunked = []
    for blen, idxs in buckets.items():
        for i in range(0, len(idxs), width):
            chunk = idxs[i:i + width]
            if len(chunk) < width and len(idxs) >= width:
                chunk = idxs[-width:]          # full-width tail (recompute)
            # a multiple of the world: the last row scored again
            chunked.append((blen, chunk + chunk[-1:] * (-len(chunk) % world)))

    pending = []
    for blen, rows_i in chunked:
        # this rank's rows of the chunk (all of them without a mesh)
        idxs = rows_i if mesh is None else rows_i[mesh.rows(len(rows_i))]
        nv_h = np.array([lens[i] for i in idxs], np.int64)
        nv = torch.as_tensor(nv_h, device=dev)
        row_keys = key_tuple = None
        if clean_cache is not None and clean_keys is not None:
            # the whole chunk's keys, the same on every rank
            row_keys = [(clean_keys[i], lens[i]) for i in rows_i]
            key_tuple = (blen,) + tuple(row_keys)

        def pack_raw(src_list):
            """[rows, blen] on the device: int16 PCM when pcm16_ok."""
            buf = np.zeros((len(idxs), blen),
                           np.int16 if pcm16_ok else dtype)
            for j, i in enumerate(idxs):
                s = np.asarray(src_list[i][:lens[i]])
                buf[j, :lens[i]] = ((s.astype(np.float32) * 32768.0).astype(
                    np.int16) if pcm16_ok else s)
            return torch.as_tensor(buf, device=dev)

        def decode(a):
            return pcm16_to_float(a, tdtype) if a.dtype == torch.int16 else a

        def pack(src_list):
            return decode(pack_raw(src_list))

        if pool is not None and enhanced_keys is not None and pcm16_ok:
            # device-resident enhanced rows, keyed by content (no n_valid
            # in the key): the mask to n_valid gives the zero-padded pack
            enh_rows = pool.ensure(("raw-enh", blen),
                                   [(enhanced_keys[i],) for i in rows_i],
                                   lambda: pack_raw(enhanced_list), mesh)
            enh = decode(enh_rows) * (
                torch.arange(blen, device=dev)[None, :]
                < nv[:, None]).to(tdtype)
        else:
            enh = pack(enhanced_list)
        if pool is not None and pool_raw_signals:
            ref = pool.ensure(("raw-ref", blen), row_keys,
                              lambda: pack(clean_list), mesh)
            noz = pool.ensure(("raw-noz", blen), row_keys,
                              lambda: pack(noise_list), mesh)
        else:
            ref, noz = pack(clean_list), pack(noise_list)
        ne = noz + enh

        def cached(name, shape_sig, compute):
            """A clean-side entry through the active cache form."""
            if pool is not None:
                return pool.ensure((name,) + shape_sig, row_keys, compute,
                                   mesh)
            k = (name,) + key_tuple
            v = clean_cache.get(k)
            if v is None:
                v = compute()
                clean_cache[k] = v
            return v

        out: Dict[str, torch.Tensor] = {}
        if "estoi" in metrics:
            ne10 = resample_poly(ne, 5, 8)
            if key_tuple is None:
                out["estoi"] = estoi_10k(resample_poly(ref, 5, 8), ne10,
                                         _nv10(nv))
            else:
                ec = cached("estoi-clean", (blen,), lambda: estoi_clean_10k(
                    resample_poly(ref, 5, 8), _nv10(nv)))
                out["estoi"] = estoi_from_clean_10k(ne10, ec, _nv10(nv))
        if "haspi" in metrics:
            ne24 = resample_to_24k(ne, 16000)
            if key_tuple is None:
                out["haspi"] = haspi_v2_24k(resample_to_24k(ref, 16000), ne24,
                                            n_valid=_nv24(nv))[0]
            else:
                cc = cached("haspi-clean", (blen,), lambda: haspi_v2_clean_24k(
                    resample_to_24k(ref, 16000), n_valid=_nv24(nv)))
                out["haspi"] = haspi_v2_from_clean_24k(ne24, cc,
                                                       n_valid=_nv24(nv))[0]
        if "pesq" in metrics:
            out["pesq"] = pesq_proxy_16k(ref, enh, nv)
        if "visqol" in metrics:
            out["visqol"] = visqol_proxy_16k(ref, enh, nv)
        if "siib" in metrics:
            # the tiling decided for the whole chunk, so that its tiled
            # bucket is the one an unsharded call takes
            sv_all = {}
            for i in rows_i:
                ck = (None if row_keys is None
                      else ("siib-vad", clean_keys[i], lens[i]))
                svj = host_cache.get(ck) if ck is not None else None
                if svj is None:
                    svj = siib_tiled_length(np.asarray(
                        clean_list[i][:lens[i]]), fs)
                    if ck is not None:
                        host_cache[ck] = svj
                sv_all[i] = svj
            sb = -(-max(sv_all.values()) // bucket_quant) * bucket_quant
            sv = torch.as_tensor(np.array([sv_all[i] for i in idxs],
                                          np.int64), device=dev)
            ref_t, ne_t = _tile(ref, nv, sv, sb), _tile(ne, nv, sv, sb)
            if key_tuple is None:
                out["siib"] = siib_gauss_16k(ref_t, ne_t, sv)
            else:
                u = cached("siib-klt", (), lambda: siib_klt_16k(ref_t, sv))
                out["siib"] = siib_gauss_16k_with_klt(ref_t, ne_t, sv, u)
        pending.append((rows_i, out))

    # one device-to-host copy for the whole corpus (and one all-gather of
    # the ranks' scores, rank-major within each chunk)
    if pending:
        names = list(pending[0][1])
        flat = torch.cat([torch.stack([out[m].to(torch.float64)
                                       for m in names]).reshape(-1)
                          for _, out in pending])
        if mesh is not None:
            flat = all_gather_rows(mesh, flat[None])
        flat = flat.cpu().numpy().reshape(world, -1)
        off = 0
        for rows_i, _ in pending:
            b = len(rows_i) // world
            chunk = np.concatenate(
                [flat[r, off:off + len(names) * b].reshape(len(names), b)
                 for r in range(world)], axis=1)
            off += len(names) * b
            for j, i in enumerate(rows_i):
                for k, m in enumerate(names):
                    raw = float(chunk[k, j])
                    results[i][m] = float(mappers[m](raw)) if norm else raw
    return results


def pcm16_to_float(a: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PCM16 samples (int16) -> `dtype` on their device, the decoder's
    formula (data/wavio.py): int16 / 32768."""
    return a.to(dtype) / 32768.0


def pad_rows_to(a: torch.Tensor, width: int) -> torch.Tensor:
    """[B, n] rows zero-padded on the right to [B, width]: the training
    loop's enhancement-bucket rows (4096-quantised) into the scoring
    bucket's (16384-quantised) enhanced-row pool."""
    return torch.nn.functional.pad(a, (0, width - a.shape[-1]))


def _pcm16_exact(x) -> bool:
    """True iff float32(x) * 32768 is integral and in int16 range, i.e.
    int16 rows decoded on the device reproduce x bit for bit."""
    s = np.asarray(x, np.float32) * np.float32(32768.0)
    if s.size == 0:
        return True
    return bool(((s >= -32768) & (s <= 32767) & (s == np.round(s))).all())
