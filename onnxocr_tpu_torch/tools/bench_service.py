"""Serving-path benchmark of the port: the HTTP v1 /ocr contract under
concurrent load, by the protocol of the JAX package's tools/bench_service.py.

It boots `python -m onnxocr_tpu_torch.service` (DEVICE, PORT=0, WARMUP=true,
MODEL_CONCURRENCY = the clients, DET_BATCH=1, REC_BATCH=1; its log in
build/bench_service/server.log), waits for /api/v2/readyz, posts every
corpus page once serially (warm-up), replays the corpus once from the
clients, then runs up to 5 timed rounds of v1 `POST /ocr` (base64 JSON)
from SERVICE_CLIENTS threads (default 8), each round the whole corpus.

    python -m onnxocr_tpu_torch.tools.bench_service [--device cuda|cpu]

prints ONE JSON line:
  {"metric": "service_images_per_sec", "value": N, "unit": "images/sec",
   "vs_baseline": N, "clients", "images", "requests", "p50_ms", "p95_ms",
   "phase_reached", "budget_s", "device": {...}}

The budget (BENCH_BUDGET_S, default 300 s) and the watchdog are the
bench's (onnxocr_tpu_torch/bench.py). A server that never becomes ready,
or a request that fails in a timed round, ends the run with a non-zero
exit after its line (phase_reached says where, "error" what). The server
binds port 0 on 127.0.0.1, and the bench reads the port the server logs:
it talks only to its own child, never to another process that holds a
fixed port. The watchdog terminates the server before it ends the run.
The recognition dictionary, where the repository lacks it, is a stand-in
under build/bench_service/ (ONNXOCR_TPU_ASSETS), and the untrained
classifier is allowed.
"""
from __future__ import annotations

import argparse
import base64
import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Optional

from .. import bench

BASELINE_IPS = bench.BASELINE_IPS
OUT_DIR = bench.REPO / "build" / "bench_service"


class ServiceBench(bench.BudgetedRun):
    tag = "svc-bench"

    def __init__(self, device: str, images_dir: Optional[str]):
        super().__init__(device, images_dir)
        self.clients = int(os.environ.get("SERVICE_CLIENTS", "8"))
        self.port = None      # the server's, read from its log
        self.proc = None

    def build_output(self) -> dict:
        lat = sorted(self.state.get("lat_ms", []))

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p / 100 * len(lat)))],
                         3) if lat else None

        value = self.state.get("ips", 0.0)
        out = {
            "metric": "service_images_per_sec",
            "value": round(value, 3),
            "unit": "images/sec",
            "vs_baseline": round(value / BASELINE_IPS, 2),
            "clients": self.clients,
            "images": self.state.get("images"),
            "requests": len(lat),
            "p50_ms": pct(50),
            "p95_ms": pct(95),
            "phase_reached": self.state.get("phase"),
            "budget_s": self.budget_s,
            "device": self.device_entry,
            "error": self.state.get("error"),
        }
        return {k: v for k, v in out.items() if v is not None}

    def stop(self):
        """Terminates the server (killed after 10 s)."""
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def post_v1(self, body: bytes, timeout: float = 120, retries: int = 1):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/ocr" % self.port, data=body,
            headers={"Content-Type": "application/json"})
        for attempt in range(retries + 1):
            try:
                r = urllib.request.urlopen(req, timeout=timeout)
                break
            except TimeoutError:
                # a cold request can sit behind a first use of its shapes
                if attempt == retries:
                    raise
        data = json.loads(r.read())
        if "error" in data:
            raise RuntimeError(data["error"])
        return data

    def server_env(self) -> dict:
        from .. import config
        env = dict(os.environ, DEVICE=self.device, HOST="127.0.0.1",
                   PORT="0", LOG_LEVEL="INFO", WARMUP="true",
                   MODEL_CONCURRENCY=str(self.clients), DET_BATCH="1", REC_BATCH="1",
                   DATA_DIR=str(OUT_DIR / "data"),
                   ONNXOCR_TPU_ALLOW_UNTRAINED="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(bench.REPO)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        if not os.path.exists(config.DEFAULTS["rec_char_dict_path"]):
            root = OUT_DIR / "assets"
            bench.standin_dict(str(root / "ppocrv5" / "ppocrv5_dict.txt"))
            env["ONNXOCR_TPU_ASSETS"] = str(root)
        return env

    def run(self) -> int:
        """The phases; → the exit code."""
        self.device_entry = bench.device_info(self.device)
        if self.images_dir is None:
            self.state["phase"] = "no-images"
            self.emit()
            return 1
        names = sorted(p for p in os.listdir(self.images_dir)
                       if p.endswith((".jpg", ".png")))
        bodies = []
        for name in names:
            with open(os.path.join(self.images_dir, name), "rb") as f:
                bodies.append(json.dumps(
                    {"image": base64.b64encode(f.read()).decode()}).encode())
        self.state["images"] = len(bodies)

        self.state["phase"] = "server-boot"
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        log_path = OUT_DIR / "server.log"
        # a fresh file: a server left from another run keeps writing into
        # the old one, never into this run's
        log_path.unlink(missing_ok=True)
        log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "onnxocr_tpu_torch.service"],
            cwd=str(bench.REPO), env=self.server_env(), stdout=log,
            stderr=subprocess.STDOUT)
        try:
            return self._phases(bodies, log_path)
        finally:
            self.stop()
            log.close()

    def _ready(self, log_path) -> bool:
        """Waits, while the child lives and at least 35 % of the budget is
        left, for the port it bound (its "serving on HOST:PORT" log line)
        and then for a 200 from /api/v2/readyz there."""
        proc = self.proc
        while self.remaining() > self.budget_s * 0.35 and \
                proc.poll() is None:
            time.sleep(0.5)
            if self.port is None:
                m = re.search(r"serving on \S+:(\d+)$",
                              log_path.read_text(errors="replace"), re.M)
                if m is None:
                    continue
                self.port = int(m.group(1))
                self.note("server bound port %d" % self.port)
            try:
                r = urllib.request.urlopen(
                    "http://127.0.0.1:%d/api/v2/readyz" % self.port,
                    timeout=3)
                if r.status == 200:
                    return proc.poll() is None
            except Exception:
                continue
        return False

    def _phases(self, bodies, log_path) -> int:
        proc = self.proc
        if not self._ready(log_path):
            self.note("server never became ready (log: %s)" % log_path)
            self.state["error"] = "server not ready" + (
                f" (exited {proc.returncode})" if proc.poll() is not None
                else "")
            self.emit()
            return 1
        self.note("server ready")

        # serial warm-up: each page once through the socket; trimmed to the
        # warmed prefix when the budget runs low
        self.state["phase"] = "warmup"
        warmed = []
        for i, b in enumerate(bodies):
            if self.remaining() < self.budget_s * 0.45 and len(warmed) >= 4:
                self.note("warmup trim %d -> %d" % (len(bodies), len(warmed)))
                break
            try:
                self.post_v1(b, timeout=max(30, min(150,
                                                    self.remaining() - 20)))
            except Exception as e:
                self.note("warmup skip image %d: %r" % (i, e))
                continue
            warmed.append(b)
        bodies = warmed
        self.state["images"] = len(bodies)

        # one concurrent replay (the concurrent paths' shapes), untimed
        self.state["phase"] = "replay"
        if self.remaining() > 40:
            with concurrent.futures.ThreadPoolExecutor(self.clients) as pool:
                list(pool.map(self.post_v1, bodies))

        # timed rounds: the whole corpus a round, from every client
        self.state["phase"] = "timed"
        lat_ms = []
        self.state["lat_ms"] = lat_ms
        round_ips = []

        def one(body):
            t = time.perf_counter()
            self.post_v1(body)
            lat_ms.append((time.perf_counter() - t) * 1000)

        for r in range(5):
            if round_ips and self.remaining() < 1.5 * (
                    len(bodies) / max(round_ips[-1], 0.2)):
                break
            t0 = time.perf_counter()
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        self.clients) as pool:
                    list(pool.map(one, bodies))
            except Exception as e:
                self.state["error"] = f"{type(e).__name__}: {e}"
                self.emit()
                return 1
            dt = time.perf_counter() - t0
            round_ips.append(len(bodies) / dt)
            self.state["ips"] = statistics.median(round_ips)
            self.note("round %d: %.2f img/s" % (r, round_ips[-1]))
        self.state["phase"] = "done"
        self.emit()
        return 0


def main(argv=None, images_dir: Optional[str] = None,
         exit_on_watchdog: bool = False) -> int:
    """Run the service benchmark (--device, default cuda) over
    `images_dir` (default: onnxocr_tpu/test_images); → the exit code. Without CUDA and without the CPU asked for, it exits
    with a message."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    from ..pipeline.system import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench_service: {e} (--device cpu)")
    sb = ServiceBench(args.device, images_dir if images_dir is not None
                      else bench.image_dir())
    threading.Thread(target=sb.watchdog, args=(exit_on_watchdog,),
                     daemon=True).start()
    return sb.run()


if __name__ == "__main__":
    sys.exit(main(exit_on_watchdog=True))
