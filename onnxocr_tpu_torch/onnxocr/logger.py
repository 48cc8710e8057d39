"""Reference surface: onnxocr/logger.py (vestigial in the reference too:
its console handler is built but never attached). A working stdlib logger
for code that imports it."""
import logging


class Logger:
    def __init__(self, name="OnnxOCR", level=logging.INFO):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        if not self.logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s"))
            self.logger.addHandler(handler)

    def get(self):
        return self.logger


def GetLog(name="OnnxOCR"):
    return Logger(name).get()
