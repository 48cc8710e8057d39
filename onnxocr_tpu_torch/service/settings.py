"""12-factor service settings (reference: app/settings.py:10-58 — same env
var names, defaults, and auto-tuning formulas). Own copy of
onnxocr_tpu/service/settings.py, plus DEVICE: the torch device the engine
runs on ("cuda" unless DEVICE=cpu), the counterpart of the JAX service's
JAX_PLATFORMS switch."""
from __future__ import annotations

import os


def _int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _bool(name: str, default: bool) -> bool:
    return os.environ.get(name, str(default)).lower() in ("true", "t", "1")


def _auto_workers() -> int:
    cpu = os.cpu_count() or 2
    return min(4, 2 * cpu)


def _auto_concurrency() -> int:
    # Reference formula is CPU-bound (min(2, cpu//2), app/settings.py:55-58).
    # Here concurrency is the *pipelining depth* in front of one card — host
    # pre/post of request k overlaps device compute of k+1 and feeds the
    # cross-request det batcher — so it should not collapse to 1 on small
    # hosts. Floor of 4, still env-overridable via MODEL_CONCURRENCY.
    cpu = os.cpu_count() or 2
    return max(4, min(8, cpu))


class Settings:
    def __init__(self):
        self.HOST = os.environ.get("HOST", "0.0.0.0")
        self.PORT = _int("PORT", 5005)
        self.WORKERS = _int("WORKERS", _auto_workers())
        self.THREADS = _int("THREADS", 2)

        self.DEFAULT_MODEL = os.environ.get("DEFAULT_MODEL", "PP-OCRv5")
        self.MODEL_POOL_SIZE = _int("MODEL_POOL_SIZE", 1)
        self.MODEL_CONCURRENCY = _int("MODEL_CONCURRENCY",
                                      _auto_concurrency())
        self.USE_GPU = _bool("USE_GPU", False)  # kept for compat
        self.DEVICE = os.environ.get("DEVICE", "cuda")
        self.WARMUP = _bool("WARMUP", True)

        self.MAX_UPLOAD_MB = _int("MAX_UPLOAD_MB", 50)
        self.MAX_CONTENT_LENGTH = self.MAX_UPLOAD_MB * 1024 * 1024

        self.LOG_LEVEL = os.environ.get("LOG_LEVEL", "INFO")
        self.LOG_FORMAT = os.environ.get("LOG_FORMAT", "plain")

        base = os.environ.get("DATA_DIR", os.path.abspath("data"))
        self.DATA_DIR = base
        self.RESULTS_DIR = os.environ.get("RESULTS_DIR",
                                          os.path.join(base, "results"))
        self.UPLOADS_DIR = os.environ.get("UPLOADS_DIR",
                                          os.path.join(base, "uploads"))


settings = Settings()
