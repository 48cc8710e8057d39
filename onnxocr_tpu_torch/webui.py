"""Web-UI launcher of the port under the reference's name and port
(webui.py: the batch-upload UI on port 5000): the service's UI and its v1
and v2 APIs, on settings.DEVICE (cuda unless DEVICE=cpu).

    python -m onnxocr_tpu_torch.webui [--port N]

--port defaults to the reference's; 0 binds a port the system chooses,
which the log's "serving on HOST:PORT" line names.
"""
import argparse
import asyncio
import logging

from .service.http import serve
from .service.routes import build_app

PORT = 5000


def main(argv=None, port: int = PORT) -> None:
    from .pipeline.system import resolve_device
    from .service.settings import settings
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=port,
                    help=f"port to bind (default {port}; 0: the system's "
                         f"choice, logged)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        resolve_device(settings.DEVICE)
    except RuntimeError as e:
        raise SystemExit(f"{e} (for the service: DEVICE=cpu)")
    asyncio.run(serve(build_app(), "0.0.0.0", args.port))


if __name__ == "__main__":
    main()
