"""The port's checkpoint substrate against the reference's, on the CPU:
checkpoints cross-load both ways, manifests and treedef strings agree, and
the pointer, rotation, torn-directory and mismatch behaviours are the
reference's."""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as R_ckpt  # noqa: E402
from repro_torch import checkpoint as T_ckpt  # noqa: E402
from repro_torch.checkpoint import io as T_io  # noqa: E402

PACKAGES = {"repro": R_ckpt, "repro_torch": T_ckpt}
RNG = np.random.default_rng(0)

# The trees the system writes (serving exports f32, int8, with a train
# state) and a few more shapes of tree, beside JAX's own treedef string
# (jax 0.9.0).
TREES = [
    ({"w": RNG.normal(size=7).astype(np.float32)}, "PyTreeDef({'w': *})"),
    ({"w": RNG.integers(-127, 128, (3, 5)).astype(np.int8),
      "scale": RNG.random(3).astype(np.float32)}, "PyTreeDef({'scale': *, 'w': *})"),
    ({"w": RNG.normal(size=6).astype(np.float32),
      "train_W": RNG.normal(size=(2, 6)).astype(np.float32),
      "train_W_sum": RNG.normal(size=(2, 6)).astype(np.float32),
      "scale": np.float32(0.5)},
     "PyTreeDef({'scale': *, 'train_W': *, 'train_W_sum': *, 'w': *})"),
    ({"c": [np.arange(3), np.ones((2, 2))], "a": {"b": np.zeros(1), "A": np.int64(4)}},
     "PyTreeDef({'a': {'A': *, 'b': *}, 'c': [*, *]})"),
    ([np.ones(2), (np.zeros(3), np.arange(4, dtype=np.int32))], "PyTreeDef([*, (*, *)])"),
    ({"x": None, "y": np.ones(2)}, "PyTreeDef({'x': None, 'y': *})"),
    (np.arange(5.0), "PyTreeDef(*)"),
]
TREE_IDS = ["f32", "int8", "train_state", "nested", "list_tuple", "none", "leaf"]


def _leaves_equal(a, b):
    la, ta = T_io.tree_flatten(a)
    lb, tb = T_io.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("tree,treedef", TREES, ids=TREE_IDS)
def test_treedef_string_is_jax(tree, treedef):
    import jax
    _, td = T_io.tree_flatten(tree)
    assert T_io.treedef_str(td) == treedef == str(jax.tree.flatten(tree)[1])


@pytest.mark.parametrize("tree,treedef", TREES, ids=TREE_IDS)
def test_flatten_order_is_jax(tree, treedef):
    import jax
    ours, _ = T_io.tree_flatten(tree)
    theirs, _ = jax.tree.flatten(tree)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"), ("repro_torch", "repro")])
@pytest.mark.parametrize("tree,treedef", TREES, ids=TREE_IDS)
def test_cross_load(tmp_path, writer, reader, tree, treedef):
    root = str(tmp_path)
    PACKAGES[writer].save(root, 12, tree, extra={"kind": "test", "n": 3})
    got = PACKAGES[reader].restore(root, tree)
    _leaves_equal(got, tree)
    m = PACKAGES[reader].read_manifest(root)
    assert m["treedef"] == treedef and m["extra"] == {"kind": "test", "n": 3}


@pytest.mark.parametrize("tree,treedef", TREES, ids=TREE_IDS)
def test_manifests_equal_but_ts(tmp_path, tree, treedef):
    manifests = []
    for name, pkg in PACKAGES.items():
        root = str(tmp_path / name)
        pkg.save(root, 3, tree, extra={"iteration": 3})
        with open(os.path.join(root, "step_000000003", "manifest.json")) as fh:
            manifests.append(json.load(fh))
        with np.load(os.path.join(root, "step_000000003", "arrays.npz")) as z:
            assert sorted(z.files) == [f"leaf_{i}" for i in range(len(z.files))]
    for m in manifests:
        assert isinstance(m.pop("ts"), float)
    assert manifests[0] == manifests[1]
    assert manifests[1]["version"] == T_io.MANIFEST_VERSION == 1


def test_other_node_types_raise():
    from collections import OrderedDict
    for bad in (OrderedDict(a=np.ones(1)), {"s": "text"}, {1, 2}, {"t": torch.ones(2)}):
        with pytest.raises(TypeError):
            T_io.tree_flatten(bad)


def test_namedtuples_flatten_as_jax_prints_them(tmp_path):
    """Optimizer states are NamedTuples: the port flattens them in JAX's
    order with JAX's treedef string, so a tree holding one crosses between
    the packages both ways."""
    from collections import namedtuple
    AdamState = namedtuple("AdamState", "step mu nu")
    Sched = namedtuple("ScheduleState", "step")
    tree = {"opt": (AdamState(np.int32(3), {"w": np.ones(2, np.float32)}, {"w": np.zeros(2)}),
                    Sched(np.int32(1))), "b": [np.arange(3)]}
    leaves, td = T_io.tree_flatten(tree)
    ref_leaves, ref_td = jax.tree.flatten(tree)
    assert T_io.treedef_str(td) == str(ref_td)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)
    back = T_io.tree_unflatten(td, leaves)
    assert type(back["opt"][0]) is AdamState and back["opt"][1].step == 1
    T_io.save(str(tmp_path / "port"), 1, tree)
    got = R_ckpt.restore(str(tmp_path / "port"), tree)
    np.testing.assert_array_equal(got["opt"][0].mu["w"], tree["opt"][0].mu["w"])
    R_ckpt.save(str(tmp_path / "ref"), 1, tree)
    got = T_ckpt.restore(str(tmp_path / "ref"), tree)
    assert type(got["opt"][1]) is Sched and int(got["opt"][0].step) == 3


@pytest.mark.parametrize("name", list(PACKAGES))
def test_latest_is_monotone_and_point_latest_rolls_back(tmp_path, name):
    ckpt, root = PACKAGES[name], str(tmp_path)
    ckpt.save(root, 7, {"w": np.ones(4, np.float32)}, keep=0)
    ckpt.save(root, 9, {"w": np.ones(4, np.float32)}, keep=0)
    assert ckpt.read_latest(root) == 9
    ckpt.save(root, 3, {"w": np.ones(4, np.float32)}, keep=0)
    assert ckpt.read_latest(root) == 9  # an older step never moves it back
    ckpt.point_latest(root, 3)
    assert ckpt.read_latest(root) == 3
    ckpt.save(root, 5, {"w": np.ones(4, np.float32)}, keep=0, point=False)
    assert ckpt.read_latest(root) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.point_latest(root, 555)
    with open(os.path.join(root, "LATEST"), "w") as fh:
        fh.write("not-a-step\n")
    assert ckpt.read_latest(root) == 9  # unparseable pointer: scan
    with open(os.path.join(root, "LATEST"), "w") as fh:
        fh.write("999\n")
    assert ckpt.read_latest(root) == 9  # dangling pointer: scan


def test_pointers_agree_across_packages(tmp_path):
    """A pointer written by one package steers the other's reads."""
    root = str(tmp_path)
    R_ckpt.save(root, 4, {"w": np.ones(2, np.float32)}, keep=0)
    T_ckpt.save(root, 6, {"w": np.zeros(2, np.float32)}, keep=0)
    assert R_ckpt.read_latest(root) == T_ckpt.read_latest(root) == 6
    R_ckpt.point_latest(root, 4)
    assert T_ckpt.read_latest(root) == 4
    np.testing.assert_array_equal(
        T_ckpt.restore(root, {"w": np.zeros(2, np.float32)}, T_ckpt.read_latest(root))["w"],
        np.ones(2, np.float32))


@pytest.mark.parametrize("name", list(PACKAGES))
def test_keep_rotates(tmp_path, name):
    ckpt, root = PACKAGES[name], str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        ckpt.save(root, step, {"w": np.full(2, step, np.float32)}, keep=2)
    assert sorted(os.listdir(root)) == ["LATEST", "step_000000004", "step_000000005"]
    assert ckpt.latest_step(root) == 5


def _tear(root, step, keep_file):
    path = os.path.join(root, f"step_{step:09d}")
    os.makedirs(path)
    if keep_file == "manifest":
        with open(os.path.join(path, "manifest.json"), "w") as fh:
            json.dump({"version": 1, "step": step, "n_leaves": 1}, fh)
    elif keep_file == "arrays":
        np.savez(os.path.join(path, "arrays.npz"), leaf_0=np.ones(4))


@pytest.mark.parametrize("keep_file", ["manifest", "arrays", "neither"])
def test_torn_step_and_staging_litter_are_invisible(tmp_path, keep_file):
    root = str(tmp_path)
    T_ckpt.save(root, 5, {"w": np.ones(4, np.float32)})
    _tear(root, 8, keep_file)
    os.makedirs(os.path.join(root, ".tmp_ckpt_inflight"))
    np.savez(os.path.join(root, ".tmp_ckpt_inflight", "arrays.npz"), leaf_0=np.ones(4))
    for ckpt in PACKAGES.values():
        assert ckpt.latest_step(root) == 5
        assert ckpt.read_latest(root) == 5
        with pytest.raises(FileNotFoundError):
            ckpt.point_latest(root, 8)


def _error(pkg, root, like):
    with pytest.raises(ValueError) as info:
        pkg.restore(root, like)
    return str(info.value)


@pytest.mark.parametrize("case", ["treedef", "leaf_count", "shape", "dtype"])
def test_mismatches_raise_the_reference_errors(tmp_path, case):
    saved = {"w": np.zeros(4, np.int8), "scale": np.zeros((), np.float32)}
    like = {
        "treedef": {"weights": np.zeros(4, np.int8), "gain": np.zeros((), np.float32)},
        "leaf_count": {"w": np.zeros(4, np.int8)},
        "shape": {"w": np.zeros(5, np.int8), "scale": np.zeros((), np.float32)},
        "dtype": {"w": np.zeros(4, np.float32), "scale": np.zeros((), np.float32)},
    }[case]
    root = str(tmp_path)
    T_ckpt.save(root, 0, saved)
    msgs = [_error(pkg, root, like) for pkg in PACKAGES.values()]
    assert msgs[0] == msgs[1]
    assert {"treedef": "saved treedef", "leaf_count": "structure mismatch",
            "shape": "checkpoint shape", "dtype": "checkpoint dtype"}[case] in msgs[1]
