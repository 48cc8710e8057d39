"""v1 service launcher of the port under the reference's port
(app-service.py: POST /ocr on port 5005), served by the port's stdlib
HTTP framework with the v2 API and the UI beside it, on settings.DEVICE
(cuda unless DEVICE=cpu). The module is named app_service: a module name
cannot hold "-".

    python -m onnxocr_tpu_torch.app_service [--port N]

--port as for webui, with 5005 as its default.
"""
from . import webui

PORT = 5005


def main(argv=None) -> None:
    webui.main(argv, PORT)


if __name__ == "__main__":
    main()
