"""Reference surface: onnxocr/predict_base.py — the session layer. A
"session" is the port's graph executor (onnxocr_tpu_torch/onnx/
executor.py) on the device the caller names; the helper methods keep the
reference's shapes: get_input_name / get_output_name return name lists,
get_input_feed feeds one tensor to every input name (the reference's
predict_base.py:42-52)."""
from ..onnx.executor import GraphExecutor

__all__ = ["PredictBase"]


class PredictBase:
    def get_onnx_session(self, model_dir, use_gpu=False, device="cuda"):
        """The executor of `model_dir` on `device` (CUDA unless the caller
        asks for the CPU; an error without CUDA). `use_gpu` is accepted
        for call compatibility and does not choose the device."""
        return GraphExecutor(model_dir, device=device)

    def get_output_name(self, session):
        return [node.name for node in session.get_outputs()]

    def get_input_name(self, session):
        return [node.name for node in session.get_inputs()]

    def get_input_feed(self, input_name, image_numpy):
        return {name: image_numpy for name in input_name}
