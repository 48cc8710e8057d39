"""In-repo ONNX support: protobuf wire parsing and the model IR (numpy
only, imported here), and the PyTorch graph executor, imported on first
use of `GraphExecutor` so that reading a model pulls in no torch op."""
from .ir import Graph, Model, Node, load_model, parse_model

__all__ = ["Model", "Graph", "Node", "load_model", "parse_model",
           "GraphExecutor"]


def __getattr__(name):
    if name == "GraphExecutor":
        from .executor import GraphExecutor
        return GraphExecutor
    raise AttributeError(name)
