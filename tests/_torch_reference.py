"""The JAX package's public-API tests, run against the port on the CPU.

``load(jax_test_file, allowlist, namespace)`` reads one test file of the
JAX suite, points its imports at ``fvgp_tpu_torch`` in place of
``fvgp_tpu``, executes it as a module of its own and puts its ``test_*``
functions and its fixtures into ``namespace`` (the calling
``tests/test_torch_reference_*.py`` module), where pytest collects them.
The JAX file is read, never written.

Inside that module only, every port entry point that defaults to the card
(a ``compute_device="cuda"`` or ``device=None`` parameter: ``GP``,
``fvGP``, ``GPLVM``, ``GPm``, ``BlockSparseMatrix``,
``gp_from_numpy_state``, ``gp_lin_alg``'s functions, ...; ``GGMP``'s
component GPs through ``gp_init_kwargs``) defaults to the CPU: classes
through thin subclasses defined in this module under their own names (so
a pickle round trip finds them), functions through a wrapper, and a port
module imported whole through a view that hands out those.  The package's
own defaults are untouched.

Every test of the JAX file runs, unless its name is on the caller's
allowlist with a key of :data:`DEVIATIONS`: a deliberate deviation of the
port that ROADMAP.md §3 records.  ``test_allowlist_is_current`` (added to
every calling module) fails on a stale or unknown entry, so nothing is
left out silently.
"""

import ast
import functools
import inspect
import re
import sys
import types
from pathlib import Path

import pytest
import torch

TESTS = Path(__file__).resolve().parent
ROADMAP = TESTS.parent / "ROADMAP.md"

# each deliberate deviation an allowlisted test meets, by the words of the
# ROADMAP §3 entry that records it (the check below finds them there)
DEVIATIONS = {
    "jax-internals": "private members of the JAX package",
    "jnp": "jnp arrays and jnp callables",
    "virtual-devices": "virtual XLA devices",
    "jax-errors": "JAX error types",
    "torch-dtypes": "torch dtypes",
    "mesh-backend": "make_mesh(backend=",
    "tpu-only": "the TPU-only names",
    "generators": "torch.Generator",
    "mesh-argument": "a mesh argument",
    "gpm-args": "GPm takes args",
    "factor-info": "check_factor(L, info)",
    "probe-source": "probe_source",
    "tensors": "torch tensors where the JAX package gives jnp arrays",
    "slow": "slow: covered by",
}


_CARD_DEFAULTS = ("cuda", "gpu", None)


def _device_parameter(fn):
    """The name of ``fn``'s device parameter when it defaults to the card
    (``compute_device="cuda"``, or ``device=None`` read as the card), else
    None."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None
    for name in ("compute_device", "device"):
        if name in params and params[name].default in _CARD_DEFAULTS:
            return name
    # GGMP places its component GPs through gp_init_kwargs
    return "gp_init_kwargs" if "gp_init_kwargs" in params else None


def _with_cpu_default(fn, name):
    """``fn`` with its device parameter ``name`` defaulting to the CPU."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if sig.bind_partial(*args, **kwargs).arguments.get(name) is None:
            kwargs[name] = "cpu"
        return fn(*args, **kwargs)
    return wrapper


_COUNTERPARTS = {}     # a port object -> its CPU-default counterpart
_ORIGINALS = {}        # and back


def _components_on_cpu(init):
    """``GGMP.__init__`` with its component GPs on the CPU unless
    ``gp_init_kwargs`` names a device."""
    @functools.wraps(init)
    def wrapper(self, *args, gp_init_kwargs=None, **kwargs):
        kw = {"compute_device": "cpu", **(gp_init_kwargs or {})}
        return init(self, *args, gp_init_kwargs=kw, **kwargs)
    return wrapper


def _cpu_class(cls, name):
    """A thin subclass of ``cls`` under its own name, defined in this module
    so that a pickle round trip finds it."""
    init = _components_on_cpu(cls.__init__) if name == "gp_init_kwargs" \
        else _with_cpu_default(cls.__init__, name)
    sub = type(cls.__name__, (cls,), {
        "__init__": init, "__module__": __name__,
        "__qualname__": cls.__name__})
    assert globals().setdefault(cls.__name__, sub) is sub, cls
    return sub


class _CpuModule(types.ModuleType):
    """A port module whose attributes are their CPU-default counterparts;
    assignments (``monkeypatch.setattr``) reach the module itself."""

    def __init__(self, real):
        super().__init__(real.__name__)
        object.__setattr__(self, "_real", real)

    def __getattr__(self, name):
        return _on_cpu(getattr(self._real, name))

    def __setattr__(self, name, value):
        setattr(self._real, name, _ORIGINALS.get(_key(value), value))

    def __delattr__(self, name):
        delattr(self._real, name)


def _key(obj):
    try:
        hash(obj)
    except TypeError:
        return None
    return obj


def _on_cpu(obj):
    """The CPU-default counterpart of a port object, else the object."""
    key = _key(obj)
    if key is None:
        return obj
    if key in _COUNTERPARTS:
        return _COUNTERPARTS[key]
    if inspect.ismodule(obj):
        ported = obj.__name__.startswith("fvgp_tpu_torch")
        out = _CpuModule(obj) if ported else obj
    elif (inspect.isclass(obj) or inspect.isfunction(obj)) \
            and str(getattr(obj, "__module__", "")).startswith(
                "fvgp_tpu_torch"):
        name = _device_parameter(obj.__init__ if inspect.isclass(obj)
                                 else obj)
        if name is None:
            out = obj
        elif inspect.isclass(obj):
            out = _cpu_class(obj, name)
        else:
            out = _with_cpu_default(obj, name)
    else:
        return obj
    _COUNTERPARTS[key] = out
    if out is not obj:
        _ORIGINALS[out] = obj
    return out


class _Retarget(ast.NodeTransformer):
    """After every import of a port name (also inside a function), rebind
    the name to its CPU-default counterpart."""

    def _rebind(self, node, names):
        out = [node]
        for name in names:
            call = ast.Call(func=ast.Name("__on_cpu__", ast.Load()),
                            args=[ast.Name(name, ast.Load())], keywords=[])
            out.append(ast.copy_location(
                ast.Assign(targets=[ast.Name(name, ast.Store())], value=call),
                node))
        return out

    def visit_ImportFrom(self, node):
        if not (node.module or "").startswith("fvgp_tpu_torch"):
            return node
        return self._rebind(node, [a.asname or a.name for a in node.names
                                   if a.name != "*"])

    def visit_Import(self, node):
        return self._rebind(node, [a.asname for a in node.names
                                   if a.asname and a.name.startswith(
                                       "fvgp_tpu_torch")])


def retargeted_source(path):
    """The JAX test file's source with ``fvgp_tpu`` read as
    ``fvgp_tpu_torch``."""
    return re.sub(r"\bfvgp_tpu\b", "fvgp_tpu_torch", Path(path).read_text())


def jax_test_names(path):
    """The names of the JAX file's module-level test functions."""
    tree = ast.parse(Path(path).read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


def _is_fixture(value):
    return hasattr(value, "_fixture_function_marker") \
        or hasattr(value, "_pytestfixturefunction") \
        or type(value).__name__ == "FixtureFunctionDefinition"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a reference module runs: under the suite's
    parallel workers torch's default of a thread per core oversubscribes
    the cores, and loops of small tensor ops slow down tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(jax_file, allowlist, namespace):
    """Expose every test of ``tests/<jax_file>`` but the allowlisted ones,
    retargeted at the port, in ``namespace``."""
    path = TESTS / jax_file
    tree = _Retarget().visit(ast.parse(retargeted_source(path)))
    ast.fix_missing_locations(tree)
    module = types.ModuleType(f"_reference_{path.stem}")
    module.__file__ = str(path)
    module.__dict__["__on_cpu__"] = _on_cpu
    sys.modules[module.__name__] = module      # what pickle looks up
    exec(compile(tree, str(path), "exec"), module.__dict__)
    for name, value in vars(module).items():
        if name.startswith("test_") and callable(value):
            if name not in allowlist:
                namespace[name] = value
        elif _is_fixture(value) or name == "pytestmark":
            namespace[name] = value

    def test_allowlist_is_current():
        """Every allowlisted name is a test of the JAX file, and each reason
        names a deviation that ROADMAP.md §3 records."""
        names = set(jax_test_names(path))
        assert set(allowlist) <= names, sorted(set(allowlist) - names)
        roadmap = ROADMAP.read_text()
        for name, (key, reason) in allowlist.items():
            assert key in DEVIATIONS and reason, name
            assert DEVIATIONS[key] in roadmap, key
    namespace["test_allowlist_is_current"] = test_allowlist_is_current
    namespace["one_torch_thread"] = one_torch_thread
    return module


