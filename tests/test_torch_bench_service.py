"""The port's service benchmark (onnxocr_tpu_torch/tools/bench_service.py)
on the CPU: it boots the port's HTTP service in a subprocess on two corpus
pages, warms, replays and times rounds of v1 /ocr from two clients within
60 s, and reaches the end of its phases; without CUDA and without
--device cpu it exits."""
import json
import shutil
import time

import pytest
import torch

from onnxocr_tpu_torch import bench
from onnxocr_tpu_torch.tools import bench_service


def test_service_bench_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    for name in ("small.jpg", "card.jpg"):
        shutil.copy(bench.REPO / "onnxocr_tpu" / "test_images" / name,
                    tmp_path / name)
    for k, v in dict(BENCH_BUDGET_S="60", SERVICE_CLIENTS="2").items():
        monkeypatch.setenv(k, v)
    t0 = time.monotonic()
    rc = bench_service.main(["--device", "cpu"], images_dir=str(tmp_path))
    took = time.monotonic() - t0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, line
    assert took < 60
    assert line["phase_reached"] == "done" and "watchdog" not in line
    assert line["images"] == 2 and line["requests"] > 0
    assert line["value"] > 0 and line["p50_ms"] > 0
    assert line["device"]["name"] == "cpu"
    assert (bench_service.OUT_DIR / "server.log").exists()


def test_without_cuda_it_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_service.main([])
    assert e.value.code not in (0, None)


def _decoy(port_box):
    """A server on a free port that answers 200 to every GET, as another
    process left on a port would."""
    import http.server
    import threading

    class Ok(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Ok)
    port_box.append(srv.server_address[1])
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_readiness_is_the_own_childs(tmp_path, monkeypatch):
    """A 200 from a port counts only while the bench's own child lives:
    a child that logged a port (another process's) and exited is never
    taken as ready, and a live child's port is the one it logged."""
    import subprocess
    import sys
    monkeypatch.setenv("BENCH_BUDGET_S", "20")
    box = []
    srv = _decoy(box)
    try:
        log = tmp_path / "server.log"
        log.write_text(f"x INFO service serving on 127.0.0.1:{box[0]}\n")
        sb = bench_service.ServiceBench("cpu", None)
        sb.proc = subprocess.Popen([sys.executable, "-c", "pass"])
        sb.proc.wait()
        t0 = time.monotonic()
        assert not sb._ready(log)
        assert time.monotonic() - t0 < 2
        sb = bench_service.ServiceBench("cpu", None)
        sb.proc = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(30)"])
        try:
            assert sb._ready(log) and sb.port == box[0]
        finally:
            sb.stop()
        assert sb.proc.poll() is not None
    finally:
        srv.shutdown()


def test_watchdog_stops_the_server(monkeypatch, capsys):
    """When the budget runs out, the watchdog emits the partial line,
    marked "watchdog", and terminates the server it booted."""
    import subprocess
    import sys
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    sb = bench_service.ServiceBench("cpu", None)
    sb.proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    t0 = time.monotonic()
    sb.watchdog(exit_process=False)
    assert time.monotonic() - t0 < 15
    assert sb.proc.poll() is not None
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["watchdog"] is True and line["phase_reached"] == "init"
