"""Reference surface: onnxocr/imaug.py — chaining of preprocessing ops.
The reference instantiates ops by eval()'ing class names from its config;
here the same names resolve through an explicit registry."""
from . import operators

__all__ = ["transform", "create_operators", "OP_REGISTRY"]

OP_REGISTRY = {
    cls.__name__: cls
    for cls in (operators.NormalizeImage, operators.DetResizeForTest,
                operators.ToCHWImage, operators.KeepKeys)
}


def transform(data, ops=None):
    """Apply a pipeline of ops to a {"image": ...} dict; None aborts."""
    for op in (ops or []):
        data = op(data)
        if data is None:
            return None
    return data


def create_operators(op_param_list, global_config=None):
    """[{OpName: params}, ...] → list of op instances (explicit registry)."""
    if not isinstance(op_param_list, list):
        raise TypeError("operator config should be a list")
    ops = []
    for spec in op_param_list:
        if not (isinstance(spec, dict) and len(spec) == 1):
            raise ValueError("each op spec must be a single-key dict")
        (op_name, params), = spec.items()
        kwargs = dict(params or {})
        if global_config:
            kwargs.update(global_config)
        try:
            op_cls = OP_REGISTRY[op_name]
        except KeyError:
            raise KeyError(f"unknown preprocessing op {op_name!r}") from None
        ops.append(op_cls(**kwargs))
    return ops
