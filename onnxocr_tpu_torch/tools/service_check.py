"""Live check of the port's HTTP service, as the JAX package's
tools/service_check.py checks its own: boots the real server (real model,
on the card), waits for readiness, sends a v1 base64 request, a v2
multipart request and GET /, and prints the recognised text beside the
rendered page's truths.

    python -m onnxocr_tpu_torch.tools.service_check [--device cuda|cpu]

It runs `python -m onnxocr_tpu_torch.service` with WARMUP=true and
MODEL_CONCURRENCY=2 (the JAX tool's settings), DEVICE from --device
(default: $DEVICE, else cuda), and ONNXOCR_TPU_ASSETS and
ONNXOCR_TPU_ALLOW_UNTRAINED passed on from its own environment, so that a
stand-in dictionary and the seeded classifier reach the server. The server
binds a port the system chooses, which the check reads from the server's
log (build/service_check/server.log); its data directory and the rendered
page (tools/eval_e2e.render_page(100), written as a PNG) go under
build/service_check/ too. It prints "ready after N s", both responses'
first six texts, the truths, the UI's status and "SERVICE CHECK OK", exits
1 with "NEVER READY" when the server does not become ready (or exits), and
terminates the server in every case.
"""
import argparse
import base64
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

from .. import bench
from ..utils import imcodec

OUT_DIR = bench.REPO / "build" / "service_check"
READY_SECONDS = 480


def server_env(device: str) -> dict:
    return dict(os.environ, HOST="127.0.0.1", PORT="0", WARMUP="true",
                MODEL_CONCURRENCY="2", DEVICE=device,
                DATA_DIR=str(OUT_DIR / "data"),
                PYTHONPATH=os.pathsep.join(
                    [str(bench.REPO)] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]))


def wait_ready(proc, log_path):
    """→ (the server's base URL, seconds to a 200 from /api/v2/readyz), or
    None when it does not answer within READY_SECONDS or exits."""
    t0 = time.perf_counter()
    base = None
    while time.perf_counter() - t0 < READY_SECONDS and proc.poll() is None:
        time.sleep(0.5)
        if base is None:
            m = re.search(r"serving on \S+:(\d+)$",
                          log_path.read_text(errors="replace"), re.M)
            if m is None:
                continue
            base = "http://127.0.0.1:%d" % int(m.group(1))
        try:
            r = urllib.request.urlopen(base + "/api/v2/readyz", timeout=3)
            if r.status == 200:
                return base, time.perf_counter() - t0
        except Exception:
            continue
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("DEVICE", "cuda"),
                    choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from .eval_heldout import check_device
    check_device("service_check", args.device)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    log_path = OUT_DIR / "server.log"
    log_path.unlink(missing_ok=True)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "onnxocr_tpu_torch.service"],
        cwd=str(bench.REPO), env=server_env(args.device), stdout=log,
        stderr=subprocess.STDOUT)
    try:
        ready = wait_ready(proc, log_path)
        if ready is None:
            print("NEVER READY", flush=True)
            return 1
        base, seconds = ready
        print("ready after %.1f s" % seconds, flush=True)

        # a synthetic page, so that the weights read known text
        from .eval_e2e import render_page
        page, truths = render_page(100)
        img_path = OUT_DIR / "tests_page.png"
        img_path.write_bytes(imcodec.imencode_png(page))
        blob = img_path.read_bytes()

        # v1
        body = json.dumps({"image": base64.b64encode(blob).decode()}).encode()
        req = urllib.request.Request(
            base + "/ocr", data=body,
            headers={"Content-Type": "application/json"})
        r = urllib.request.urlopen(req, timeout=120)
        data = json.loads(r.read())
        print("v1 status", r.status, "results:",
              [x["text"] for x in data["results"]][:6], flush=True)

        # v2 multipart
        boundary = "XB0UND"
        part = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="file"; filename="p.png"\r\n'
                f"Content-Type: image/png\r\n\r\n").encode() + blob + (
            f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"conf_threshold\"\r\n\r\n0.3\r\n--{boundary}--\r\n"
        ).encode()
        req = urllib.request.Request(
            base + "/api/v2/ocr", data=part,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        r = urllib.request.urlopen(req, timeout=120)
        data = json.loads(r.read())
        print("v2 status", r.status, "results:",
              [x["text"] for x in data["results"]][:6], flush=True)
        print("truths:", [t for t, _ in truths], flush=True)
        print("UI:", urllib.request.urlopen(base + "/", timeout=10).status,
              flush=True)
        print("SERVICE CHECK OK", flush=True)
        return 0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


if __name__ == "__main__":
    sys.exit(main())
