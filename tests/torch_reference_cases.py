"""Run the JAX package's own swarm test files on the port's copies.

A reference test file's text, with its import root rewritten to the port
(``tests/test_torch_swarm_drift.py``'s rewrite), is executed in a namespace
of its own; every test class and test function it defines is then bound into
the calling test module, so pytest collects each one there with its own
marks, parameters and fixtures. Nothing in the reference's files changes.

Cases that import a reference experiment script (``from experiments.X
import ...``) get that script's text under the same rewrite, loaded as the
module ``ported_experiments.X``; the cases' text names that module instead.
Cases that import helpers of another reference test file (``from
tests.test_averaging import ...``) get that file the same way, as
``ported_tests.test_averaging``.
Every port averager these cases build without a codec of its own uses the
process default, which ``device_codec`` sets to the device backend on CPU
tensors (the plain versions of K4 and K5).
"""

from __future__ import annotations

import re
import sys
import types
from pathlib import Path
from typing import Dict, Iterable, Optional

import pytest

REPO = Path(__file__).resolve().parent.parent
ROOT = re.compile(r"\bdistributedvolunteercomputing_tpu(?=[.\s])")
PORT_ROOT = "distributedvolunteercomputing_tpu_torch"


def ported_text(path: Path) -> str:
    return ROOT.sub(PORT_ROOT, path.read_text())


def load_experiment(name: str) -> types.ModuleType:
    """``experiments/<name>.py`` on the port, as ``ported_experiments.<name>``."""
    return _load_ported("experiments", name)


def load_test_module(name: str) -> types.ModuleType:
    """``tests/<name>.py`` on the port, as ``ported_tests.<name>``."""
    return _load_ported("tests", name)


def _load_ported(folder: str, name: str) -> types.ModuleType:
    root = f"ported_{folder}"
    full = f"{root}.{name}"
    if full in sys.modules:
        return sys.modules[full]
    pkg = sys.modules.get(root)
    if pkg is None:
        pkg = types.ModuleType(root)
        pkg.__path__ = []
        sys.modules[root] = pkg
    path = REPO / folder / f"{name}.py"
    mod = types.ModuleType(full)
    mod.__file__ = str(path)
    sys.modules[full] = mod
    try:
        exec(compile(ported_text(path), str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[full]
        raise
    setattr(pkg, name, mod)
    return mod


def port_cases(
    test_file: str,
    into: dict,
    drop: Optional[Dict[str, str]] = None,
    experiments: Iterable[str] = (),
    keep: Optional[Iterable[str]] = None,
    test_modules: Iterable[str] = (),
) -> dict:
    """Execute ``tests/<test_file>`` on the port and bind its cases into the
    module namespace ``into``. ``drop``: ``"Class.method"`` or ``"function"``
    -> the reason the case does not run as is (the caller supplies its
    replacement). ``experiments``: the experiment scripts its cases import.
    ``keep``: only these classes and functions (None = all). ``test_modules``:
    the reference test files whose helpers it imports. Returns the namespace
    the file ran in."""
    path = REPO / "tests" / test_file
    src = ported_text(path)
    for name in experiments:
        load_experiment(name)
        src = src.replace(f"experiments.{name}", f"ported_experiments.{name}")
    for name in test_modules:
        load_test_module(name)
        src = src.replace(f"tests.{name}", f"ported_tests.{name}")
    ns = {"__name__": f"ported_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    for case in drop or {}:
        owner, _, method = case.rpartition(".")
        if owner:
            delattr(ns[owner], method)  # this namespace's own class, not the reference's
        else:
            del ns[method]
    keep = None if keep is None else set(keep)
    for name, obj in ns.items():
        if keep is not None and name not in keep:
            continue
        if (name.startswith("Test") and isinstance(obj, type)) or (name.startswith("test_") and callable(obj)):
            if name in into:
                raise AssertionError(f"{test_file}: {name} is already defined in the calling module")
            into[name] = obj
    if "pytestmark" in ns:
        into["pytestmark"] = ns["pytestmark"]
    return ns


def count_cases(ns: dict) -> int:
    """Test functions and methods a namespace defines (before parametrization)."""
    n = 0
    for name, obj in ns.items():
        if name.startswith("Test") and isinstance(obj, type):
            n += sum(1 for m in vars(obj) if m.startswith("test_"))
        elif name.startswith("test_") and callable(obj):
            n += 1
    return n


@pytest.fixture(autouse=True)
def device_codec():
    """The process default codec for the case: the device backend on CPU
    tensors, as the volunteer runs it on the card."""
    from distributedvolunteercomputing_tpu_torch import native
    from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

    assert native.ensure_built()
    codec = mc.configure(device="cpu", backend="device")
    try:
        yield codec
    finally:
        mc.reset()
