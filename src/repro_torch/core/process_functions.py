"""calcfunction / workfunction decorators (paper §II.B.1–2).

A decorated plain Python function becomes a full process when called: the
engine introspects the signature to build a ProcessSpec on the fly, creates
the provenance node, links inputs, runs the body synchronously (process
functions intentionally block — §II.B.2), and links outputs.

calcfunction — *creates* data (CREATE links);
workfunction — *orchestrates*: returns existing data (RETURN links) and the
processes it calls get CALL links (fig. 2).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable

from repro_torch.core.datatypes import DataValue, to_data_value
from repro_torch.core.exit_code import ExitCode
from repro_torch.core.process import Process
from repro_torch.core.process_spec import ProcessSpec
from repro_torch.provenance.store import NodeType


def _make_function_process(fn: Callable, node_type: NodeType) -> type:
    sig = inspect.signature(fn)
    pos_names = [p.name for p in sig.parameters.values()
                 if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)]
    has_var_kw = any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values())

    from repro_torch.caching.hashing import source_salt

    class FunctionProcess(Process):
        NODE_TYPE = node_type
        _func = staticmethod(fn)
        _pos_names = pos_names
        # editing the function body changes the fingerprint, so stale
        # cached results of the old implementation are never reused
        _cache_extra_salt = source_salt(fn)

        @classmethod
        def define(cls, spec: ProcessSpec) -> None:
            super().define(spec)
            for p in sig.parameters.values():
                if p.kind is p.VAR_KEYWORD:
                    continue
                kwargs: dict[str, Any] = {"valid_type": DataValue}
                ann = p.annotation
                if isinstance(ann, type) and issubclass(ann, DataValue):
                    kwargs["valid_type"] = ann   # type annotations augment
                if p.default is not inspect.Parameter.empty:
                    kwargs["default"] = p.default
                    kwargs["required"] = False
                spec.input(p.name, **kwargs)
            if has_var_kw:
                spec.inputs.dynamic = True
            spec.outputs.dynamic = True

        async def run(self):
            kwargs = {k: v for k, v in self.inputs.items()
                      if k != "metadata"}
            result = self._func(**kwargs)
            if isinstance(result, ExitCode):
                return result
            if result is not None:
                if isinstance(result, dict) and not isinstance(result, DataValue):
                    for k, v in result.items():
                        self.out(k, to_data_value(v))
                    # so a cache hit can reproduce the dict-shaped return
                    # even when the dict has a single 'result' key; stashed
                    # so it commits with the terminal transaction
                    self.stash_attributes({"returns_dict": True})
                else:
                    self.out("result", to_data_value(result))
            self._result_value = result
            return None

    FunctionProcess.__name__ = fn.__name__
    FunctionProcess.__qualname__ = fn.__name__
    FunctionProcess.__module__ = fn.__module__
    return FunctionProcess


def _process_function(fn: Callable, node_type: NodeType) -> Callable:
    process_class = _make_function_process(fn, node_type)
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        inputs: dict[str, Any] = {}
        for name, value in bound.arguments.items():
            param = sig.parameters[name]
            if param.kind is param.VAR_KEYWORD:
                for k2, v2 in value.items():
                    inputs[k2] = to_data_value(v2)
            else:
                inputs[name] = to_data_value(value)
        from repro_torch.engine.runner import default_runner
        runner = default_runner()
        process = process_class(inputs=inputs, runner=runner)
        exit_code = runner.run_sync(process)
        if exit_code.status == 999:
            logs = runner.store.get_logs(process.pk)
            err = logs[-1]["message"] if logs else "unknown error"
            raise RuntimeError(
                f"{fn.__name__} (pk={process.pk}) excepted:\n{err}")
        result = getattr(process, "_result_value", None)
        if result is None and process.outputs:
            return _outputs_as_result(process)  # cache hit: run() never
            # executed, the cloned outputs carry the return value
        if result is None and isinstance(exit_code, ExitCode) and \
                not exit_code.is_finished_ok:
            return exit_code
        if isinstance(result, dict) and not isinstance(result, DataValue):
            return {k: to_data_value(v) for k, v in result.items()}
        return to_data_value(result) if result is not None else None

    wrapper.process_class = process_class
    wrapper.run_get_node = lambda *a, **kw: _run_get_node(wrapper, process_class,
                                                          sig, *a, **kw)
    return wrapper


def _outputs_as_result(process: Process) -> Any:
    """Rebuild a cache-hit process's return value from its cloned outputs,
    with the same shape the original call produced (the `returns_dict`
    attribute is carried over from the cache source)."""
    import json

    outputs = dict(process.outputs)
    node = process.store.get_node(process.pk) or {}
    attrs = json.loads(node.get("attributes") or "{}")
    if not attrs.get("returns_dict") and set(outputs) == {"result"}:
        return outputs["result"]
    return outputs


def _run_get_node(wrapper, process_class, sig, *args, **kwargs):
    from repro_torch.engine.runner import default_runner
    bound = sig.bind(*args, **kwargs)
    inputs = {}
    for name, value in bound.arguments.items():
        param = sig.parameters[name]
        if param.kind is param.VAR_KEYWORD:
            for k2, v2 in value.items():
                inputs[k2] = to_data_value(v2)
        else:
            inputs[name] = to_data_value(value)
    runner = default_runner()
    process = process_class(inputs=inputs, runner=runner)
    exit_code = runner.run_sync(process)
    result = getattr(process, "_result_value", None)
    if result is None and process.outputs:
        out = _outputs_as_result(process)
        if isinstance(out, dict):
            # cold dict-returns come back as one Dict DataValue here;
            # rebuild that shape from the cloned outputs
            out = to_data_value({k: v.value if isinstance(v, DataValue)
                                 else v for k, v in out.items()})
        return out, process, exit_code
    return (to_data_value(result) if result is not None else None,
            process, exit_code)


def calcfunction(fn: Callable) -> Callable:
    """Lift a plain function into a provenance-tracked calculation."""
    return _process_function(fn, NodeType.CALC_FUNCTION)


def workfunction(fn: Callable) -> Callable:
    """Lift a plain function into a provenance-tracked workflow."""
    return _process_function(fn, NodeType.WORK_FUNCTION)
