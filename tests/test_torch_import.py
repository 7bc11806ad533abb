"""Import rules of the port: no JAX and nothing of ``repro`` anywhere in
``repro_torch``, ``chip_smoke.py`` or the port's examples
(``examples/torch_*.py``), and no silent CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import load as load_example  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)


# the modules of the training slice, named so a rename cannot drop them unseen
TRAINING_MODULES = ["repro_torch.optim", "repro_torch.optim.schedules",
                    "repro_torch.optim.transforms", "repro_torch.data.tokens",
                    "repro_torch.models.moe", "repro_torch.launch.input_specs",
                    "repro_torch.launch.steps", "repro_torch.launch.train"]
# the modules of the sharding slice
SHARDING_MODULES = ["repro_torch.sharding", "repro_torch.sharding.api", "repro_torch.launch.mesh",
                    "repro_torch.launch.shardings", "repro_torch.launch.hlo_parse",
                    "repro_torch.launch.dryrun"]


def test_every_module_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
assert set({TRAINING_MODULES!r}) <= set(names), sorted(set({TRAINING_MODULES!r}) - set(names))
assert set({SHARDING_MODULES!r}) <= set(names), sorted(set({SHARDING_MODULES!r}) - set(names))
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not leaked, leaked
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 92  # every module of the port was imported


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_gadget_train_without_card_raises(monkeypatch):
    from repro_torch.core.gadget import GadgetConfig, gadget_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((2, 3, 4), np.float32)
    y = np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gadget_train(X, y, GadgetConfig(max_iters=2))
    gadget_train(X, y, GadgetConfig(max_iters=2), device="cpu")  # asking for the CPU works


def test_svm_server_without_card_raises(monkeypatch):
    from repro_torch.serve import SvmServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SvmServer(w)
    labels = SvmServer(w, device="cpu").score(np.ones((2, 4), np.float32))[1]
    np.testing.assert_array_equal(labels, [1.0, 1.0])  # asking for the CPU works


EXAMPLES = ["torch_quickstart", "torch_fault_tolerant_gossip", "torch_serve_batched",
            "torch_gossip_vs_allreduce", "torch_train_100m"]


def _new_entry_points():
    from repro_torch.core import cutting_plane, gadget, multiclass, pegasos
    from repro_torch.serve import make_mesh_scorer
    X = np.zeros((2, 3, 4), np.float32)
    y = np.ones((2, 3), np.float32)
    cfg = gadget.GadgetConfig(max_iters=2)
    return {
        "gadget_train_reference": lambda **kw: gadget.gadget_train_reference(X, y, cfg, **kw),
        "pegasos_train": lambda **kw: pegasos.pegasos_train(X[0], y[0], 1e-2, 2, **kw),
        "cutting_plane_svm": lambda **kw: cutting_plane.cutting_plane_svm(
            X[0], y[0], 1e-2, max_cuts=2, **kw),
        "svm_sgd": lambda **kw: cutting_plane.svm_sgd(X[0], y[0], 1e-2, n_epochs=1, **kw),
        "gadget_train_multiclass": lambda **kw: multiclass.gadget_train_multiclass(
            X, np.zeros((2, 3), np.int32), 2, cfg, **kw),
        "make_mesh_scorer": lambda **kw: make_mesh_scorer(np.ones(4, np.float32), **kw),
        **{name: (lambda name=name, **kw: load_example(name).main([])) for name in EXAMPLES},
    }


@pytest.mark.parametrize("name", ["gadget_train_reference", "pegasos_train",
                                  "cutting_plane_svm", "svm_sgd",
                                  "gadget_train_multiclass", "make_mesh_scorer"] + EXAMPLES)
def test_new_entry_points_without_card_raise(monkeypatch, name):
    """Each raises without a card unless the CPU is asked for; an example's
    ``main`` with no ``--device`` raises before it builds anything
    (``--device cpu`` runs it: ``tests/test_torch_examples.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _new_entry_points()[name]()
    # the scorer needs a process group past the device check; the examples
    # run whole at their own sizes
    if name != "make_mesh_scorer" and name not in EXAMPLES:
        _new_entry_points()[name](device="cpu")  # asking for the CPU works
