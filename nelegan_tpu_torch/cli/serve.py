"""Serving daemon: persistent enhancement service with dynamic batching.

Counterpart of `nelegan_tpu/cli/serve.py`, with the same wire protocol byte
for byte and the same batching.  The daemon keeps one generator resident on
the GPU and feeds it full batches:

  * concurrent requests are collected into bucketed batches: a request of n
    samples goes to the bucket ceil(n / 4096) * 4096, same-bucket arrivals
    within `max_wait_ms` share a batch, and each batch is padded to the
    fixed batch size by repeating its last row;
  * all device work (`pipeline.featurize_batch` + `pipeline.enhance_batch`,
    whose IMCRA runs as the `imcra_scan` CUDA kernel) runs on ONE worker
    thread, while socket threads only move bytes and wait on per-request
    events; a failed batch returns its error to every client in it.

Protocol (TCP, length-prefixed, little-endian, 16 kHz float32 PCM):

    request:  magic b'NELE' | u8 version=1 | u32 n | f32[n] clean
                                           | u32 m | f32[m] noise
    response: u32 k | f32[k] enhanced          (RMS-normalised to 0.03)
           or u32 0xFFFFFFFF | u32 len | utf-8 error message

`enhance_remote()` is the matching client helper.

    python -m nelegan_tpu_torch.cli.serve --torch-checkpoint chkpt_GD.pt \\
        [--port 7860] [--batch-size 8] [--max-wait-ms 15] \\
        [--warmup-lengths 36864] [--device cuda]

Weights come from a reference `chkpt_GD.pt` (its 'enhance-model' state
dict, loaded directly).  The reference package's native msgpack checkpoints
need its train/checkpoint.py, which is ported with the training slice; until
then they cannot be served from here.
"""
from __future__ import annotations

import argparse
import queue
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from nelegan_tpu_torch import pipeline
from nelegan_tpu_torch.config import Config
from nelegan_tpu_torch.device import disable_tf32, resolve_device
from nelegan_tpu_torch.models.convert import load_reference_checkpoint
from nelegan_tpu_torch.models.generator import Generator

MAGIC = b"NELE"
VERSION = 1
ERR = 0xFFFFFFFF
MAX_SAMPLES = 16000 * 120  # 2 minutes per signal: bounds request memory
BUCKET_QUANT = 4096        # bucket lengths are multiples of this


# ----------------------------------------------------------------- wire IO
def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_f32(sock: socket.socket) -> np.ndarray:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    if n > MAX_SAMPLES:
        raise ValueError(f"signal too long ({n} samples > {MAX_SAMPLES})")
    return np.frombuffer(_recv_exact(sock, 4 * n), "<f4").copy()


def _send_f32(sock: socket.socket, wav: np.ndarray) -> None:
    wav = np.ascontiguousarray(wav, "<f4")
    sock.sendall(struct.pack("<I", wav.size) + wav.tobytes())


def _send_error(sock: socket.socket, msg: str) -> None:
    data = msg.encode()[:4096]
    sock.sendall(struct.pack("<II", ERR, len(data)) + data)


def enhance_remote(host: str, port: int, clean: np.ndarray,
                   noise: np.ndarray, timeout: float = 60.0) -> np.ndarray:
    """Client helper: one round trip against a running daemon."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(MAGIC + struct.pack("<B", VERSION))
        _send_f32(s, clean)
        _send_f32(s, noise)
        (k,) = struct.unpack("<I", _recv_exact(s, 4))
        if k == ERR:
            (n,) = struct.unpack("<I", _recv_exact(s, 4))
            raise RuntimeError(_recv_exact(s, n).decode())
        return np.frombuffer(_recv_exact(s, 4 * k), "<f4").copy()


# ----------------------------------------------------------------- batcher
class _Request:
    __slots__ = ("clean", "noise", "event", "result", "error")

    def __init__(self, clean: np.ndarray, noise: np.ndarray):
        self.clean = clean
        self.noise = noise
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None

    def wait(self) -> np.ndarray:
        self.event.wait()
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.result


class EnhanceServer:
    """Dynamic-batching enhancement service around one generator.

    `generator` is moved to `device` (None means CUDA, and raises without
    a GPU) and put in eval mode; the server owns it from then on."""

    def __init__(self, generator: torch.nn.Module, batch_size: int = 8,
                 max_wait_ms: float = 15.0, device=None):
        self.device = resolve_device(device)
        self.cfg = Config()
        self.generator = generator.to(self.device).eval()
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0}
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self._stopping = threading.Event()
        self._started = False

    # --- device side ---------------------------------------------------
    @torch.inference_mode()
    def _step(self, clean_p: np.ndarray, noise_p: np.ndarray,
              lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        p_power = self.cfg.train.p_power
        feats = pipeline.featurize_batch(clean_p, noise_p, lengths, p_power,
                                         self.cfg.imcra, device=self.device)
        wav, _, out_len = pipeline.enhance_batch(
            self.generator, feats, p_power, self.cfg.train.target_rms,
            device=self.device)
        return wav.cpu().numpy(), out_len.cpu().numpy()

    @staticmethod
    def _bucket(n: int) -> int:
        return -(-max(n, 1) // BUCKET_QUANT) * BUCKET_QUANT

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._worker.start()

    def warmup(self, lengths: List[int]) -> None:
        """Run each bucket once ahead of traffic (builds the kernels and
        cuFFT plans), as synthetic requests through the normal queue so the
        warmed path is the served path."""
        self.start()
        rng = np.random.RandomState(0)
        for n in lengths:
            wav = 0.03 * rng.randn(self._bucket(n)).astype(np.float32)
            req = _Request(wav, wav)
            self.queue.put(req)
            req.wait()

    def _batch_loop(self):
        while not self._stopping.is_set():
            try:
                first = self.queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if first is None:
                break
            group = [first]
            deadline = time.perf_counter() + self.max_wait
            # collect same-bucket requests until the batch fills or the
            # window closes; different-bucket arrivals go back in the queue
            blen = self._bucket(min(first.clean.size, first.noise.size))
            requeue = []
            while len(group) < self.batch_size:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    r = self.queue.get(timeout=left)
                except queue.Empty:
                    break
                if r is None:
                    self._stopping.set()
                    break
                if self._bucket(min(r.clean.size, r.noise.size)) == blen:
                    group.append(r)
                else:
                    requeue.append(r)
            for r in requeue:
                self.queue.put(r)
            self._run_group(group, blen)
        self._drain()

    def _run_group(self, group: List[_Request], blen: int) -> None:
        try:
            cleans, noises = [], []
            for r in group:
                n = min(r.clean.size, r.noise.size)
                cleans.append(r.clean[:n])
                noises.append(r.noise[:n])
            # pad to the fixed batch size by repeating the last row: every
            # batch of a bucket has one shape
            while len(cleans) < self.batch_size:
                cleans.append(cleans[-1])
                noises.append(noises[-1])
            clean_p, lengths = pipeline.reflect_pad_batch(cleans, blen)
            noise_p, _ = pipeline.reflect_pad_batch(noises, blen)
            wavs, out_lens = self._step(clean_p, noise_p, lengths)
            for i, r in enumerate(group):
                r.result = wavs[i, :int(out_lens[i])]
                r.event.set()
            self.stats["requests"] += len(group)
            self.stats["batches"] += 1
        except Exception as e:  # noqa: BLE001 — report to the waiting client
            for r in group:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()

    def _drain(self):
        while True:
            try:
                r = self.queue.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                r.error = "server shutting down"
                r.event.set()

    # --- socket side ---------------------------------------------------
    def _client(self, sock: socket.socket) -> None:
        with sock:
            try:
                while True:
                    try:
                        head = _recv_exact(sock, 5)
                    except ConnectionError:
                        return  # clean disconnect between requests
                    if head[:4] != MAGIC or head[4] != VERSION:
                        _send_error(sock, "bad magic/version")
                        return
                    req = _Request(_recv_f32(sock), _recv_f32(sock))
                    if req.clean.size == 0 or req.noise.size == 0:
                        _send_error(sock, "empty signal")
                        continue
                    self.queue.put(req)
                    req.event.wait()
                    if req.error is not None:
                        _send_error(sock, req.error)
                    else:
                        _send_f32(sock, req.result)
            except (ConnectionError, ValueError, OSError) as e:
                try:
                    _send_error(sock, str(e))
                except OSError:
                    pass

    def serve(self, host: str = "127.0.0.1", port: int = 7860,
              ready_event: Optional[threading.Event] = None
              ) -> Tuple[str, int]:
        """Blocking accept loop.  Pass port=0 for an ephemeral port; the
        bound address is stored on `self.address` before `ready_event`
        fires (for callers running the server in a thread)."""
        self.start()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        srv.settimeout(0.25)
        self.address = srv.getsockname()
        if ready_event is not None:
            ready_event.set()
        print(f"serving on {self.address[0]}:{self.address[1]} "
              f"(batch={self.batch_size}, wait={self.max_wait * 1e3:.0f} ms, "
              f"device={self.device})")
        try:
            while not self._stopping.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                threading.Thread(target=self._client, args=(conn,),
                                 daemon=True).start()
        finally:
            srv.close()
        return self.address

    def stop(self):
        self._stopping.set()
        self.queue.put(None)
        if self._started:
            self._worker.join(timeout=10)


# ----------------------------------------------------------------- CLI
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch-checkpoint", required=True,
                   help="reference chkpt_GD.pt (its 'enhance-model' entry)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=15.0)
    p.add_argument("--warmup-lengths", default="36864",
                   help="comma-separated sample counts to run once before "
                        "serving (empty to skip)")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a GPU pass 'cpu' explicitly")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()   # serve in full float32, the generator's parity bar
    generator = Generator()
    generator.load_state_dict(load_reference_checkpoint(args.torch_checkpoint),
                              strict=True)
    server = EnhanceServer(generator, batch_size=args.batch_size,
                           max_wait_ms=args.max_wait_ms, device=device)
    warm = [int(x) for x in args.warmup_lengths.split(",") if x.strip()]
    if warm:
        t0 = time.perf_counter()
        server.warmup(warm)
        print(f"warmed {len(warm)} bucket(s) in "
              f"{time.perf_counter() - t0:.1f} s")
    try:
        server.serve(args.host, args.port)
    except KeyboardInterrupt:
        pass
    server.stop()


if __name__ == "__main__":
    main()
