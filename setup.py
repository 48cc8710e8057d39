"""Package metadata so the engine pip-installs into serving images."""
from setuptools import setup, find_packages

setup(
    name="onnxocr-tpu",
    version="0.1.0",
    description="TPU-native OCR engine (JAX/XLA/Pallas) with the "
                "ding113/OnnxOCR API surface",
    packages=find_packages(include=["onnxocr_tpu", "onnxocr_tpu.*",
                                    "onnxocr", "onnxocr.*",
                                    "onnxocr_tpu_torch",
                                    "onnxocr_tpu_torch.*"]),
    package_data={
        "onnxocr_tpu": ["runtime/native/*.cc",
                        "assets/**/*.npz"],
        "onnxocr_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/host/*.cc",
                              "assets/fonts/dejavu/*"],
    },
    python_requires=">=3.10",
    install_requires=["jax>=0.4.30", "numpy", "optax"],
    extras_require={
        "host": ["opencv-python-headless", "pillow"],
        "tpu": ["jax[tpu]>=0.4.30"],
    },
)
